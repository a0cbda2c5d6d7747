"""The slice-data parse (native/slice_parse.cpp, MV derivation and the
picture's plan included), ms per decoded picture: the trace's dec.parse
spans over its dec.finish pictures, in the profiled part of a traced
decode."""
from hevc_bench.program_trace import ms_per_picture


def read(run):
    return ms_per_picture(("dec.parse",), "dec.finish")
