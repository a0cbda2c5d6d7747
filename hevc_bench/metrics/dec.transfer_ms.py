"""The decode's transfers, ms per decoded picture: the trace's dec.upload
and dec.pull spans (a pull holds its wait for the card's work on the
planes) over its dec.finish pictures, in the profiled part of a traced
decode."""
from hevc_bench.program_trace import ms_per_picture


def read(run):
    return ms_per_picture(("dec.upload", "dec.pull"), "dec.finish")
