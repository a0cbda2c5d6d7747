"""The native core's inter CU decisions (merge, AMVP, full-pel and
sub-pel search, their transforms and rate), thread-ms per coded picture:
the inter_cu phase timer of enc_core.cpp summed over the walk's row
threads (enc.native.inter_cu_ns), over the trace's enc.docket pictures,
in the profiled part of a traced encode."""
from hevc_bench.program_trace import per_picture, trace


def read(run):
    tr = trace()
    if tr is None or not tr.counter("enc.native.inter_cu_ns"):
        return None
    v = per_picture(("enc.native.inter_cu_ns",), "enc.docket")
    return None if v is None else v / 1e6
