"""The check of each picture's MD5 picture-hash SEI, ms per decoded
picture: the trace's dec.hash spans over its dec.finish pictures, in the
profiled part of a traced decode."""
from hevc_bench.program_trace import ms_per_picture


def read(run):
    return ms_per_picture(("dec.hash",), "dec.finish")
