"""The device pipeline's host glue, ms per picture through the pipeline:
the self time of the trace's dec.mc, dec.residual, dec.deblock and
dec.sao stage spans (their dec.upload and dec.pull children left out),
over the dec.mc spans (one a pipeline picture), in the profiled part of a
traced decode. Kernel launches are enqueued here; the card is not
waited for."""
from hevc_bench.program_trace import trace

STAGES = ("dec.mc", "dec.residual", "dec.deblock", "dec.sao")


def read(run):
    tr = trace()
    if tr is None:
        return None
    spans = tr.summary()["spans"]
    n = spans.get("dec.mc", {}).get("count", 0)
    if not n:
        return None
    return sum(spans[s]["self_ns"] for s in STAGES if s in spans) / 1e6 / n
