"""SAO estimation, ms per coded picture: the trace's enc.sao_search spans
(estimate_sao: each CTB's band and edge offsets and the merge decisions,
on the deblocked picture) over its enc.docket pictures, in the profiled
part of a traced encode. A program without the span reads nothing."""
from hevc_bench.program_trace import ms_per_picture


def read(run):
    return ms_per_picture(("enc.sao_search",), "enc.docket")
