"""The native core's bi-prediction search (the alternating refinement of
both lists' motion and the bi candidate's cost), thread-ms per coded
picture: the bi_refine phase timer of enc_core.cpp summed over the
walk's row threads (enc.native.bi_refine_ns), over the trace's
enc.docket pictures, in the profiled part of a traced encode. A program
without the timer reads nothing."""
from hevc_bench.program_trace import per_picture, trace


def read(run):
    tr = trace()
    if tr is None or not tr.counter("enc.native.bi_refine_ns"):
        return None
    v = per_picture(("enc.native.bi_refine_ns",), "enc.docket")
    return None if v is None else v / 1e6
