"""The port's own trace (turingcodec_tpu_torch/utils/profiler.py) as the
per-layer metrics whose source is program_span read it. The program
records while torch.profiler records, so after a traced run the trace
holds the spans and counters of its profiled part. Each function gives
None where the program has no such trace or recorded nothing of what is
asked."""


def trace():
    """The port's trace if it recorded anything, else None."""
    from turingcodec_tpu_torch.utils import profiler
    tr = getattr(profiler, "TRACE", None)
    if tr is None or not getattr(tr, "spans", None):
        return None
    return tr


def pictures(tr, root: str) -> int:
    """The pictures recorded: root spans of the name."""
    return sum(1 for s in tr.spans if s[0] == root and s[3] == s[5])


def ms_per_picture(names, root: str):
    """The spans of `names` summed, in ms per picture of `root`."""
    tr = trace()
    if tr is None:
        return None
    n = pictures(tr, root)
    spans = tr.summary()["spans"]
    if not n or not any(k in spans for k in names):
        return None
    return sum(spans[k]["total_ns"] for k in names if k in spans) / 1e6 / n


def per_picture(counters, root: str):
    """The counters summed, per picture of `root`."""
    tr = trace()
    if tr is None:
        return None
    n = pictures(tr, root)
    if not n:
        return None
    return sum(sum(tr.counter(c).values()) for c in counters) / n
