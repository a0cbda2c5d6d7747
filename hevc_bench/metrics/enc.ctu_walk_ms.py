"""The CTU walk, ms per coded picture: the native core's whole-picture
RDO search (tc_enc_picture, WPP row threads inside), the trace's
enc.ctu_walk spans over its enc.docket pictures, in the profiled part of
a traced encode."""
from hevc_bench.program_trace import ms_per_picture


def read(run):
    return ms_per_picture(("enc.ctu_walk",), "enc.docket")
