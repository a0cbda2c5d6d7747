"""How busy frame-parallel batches keep the WPP thread budget they share,
in %: the ns the coded pictures' CTU walk threads spent inside
decide_cqt (each picture's own enc.wpp.ctu_ns), over each batch's thread
budget (enc.batch.threads) times its encode phase (the enc.batch span),
summed over the profiled part of a traced encode. A batch of one picture
counts as one. The rest is the walks' waits, ramps and ends, and each
picture's loop filter, SAO estimation and writing beside the other's
walk. A program without the batch span reads nothing."""
from hevc_bench.program_trace import trace


def read(run):
    tr = trace()
    if tr is None:
        return None
    batches = tr.durations("enc.batch")
    threads = tr.counter("enc.batch.threads")
    den = sum(threads[r] * batches[r] for r in batches if r in threads)
    if den <= 0:
        return None
    return 100.0 * sum(tr.counter("enc.wpp.ctu_ns").values()) / den
