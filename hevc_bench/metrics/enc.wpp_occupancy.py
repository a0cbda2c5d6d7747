"""How busy the CTU walk keeps its row threads, in %: the ns the threads
spent inside decide_cqt (enc.wpp.ctu_ns), over the thread count
(enc.wpp.threads) times the walk's span (enc.ctu_walk), summed over the
profiled part's pictures of a traced encode. The rest is the wait on the
row above, the walk's start and end, and the threads' start."""
from hevc_bench.program_trace import trace


def read(run):
    tr = trace()
    if tr is None:
        return None
    walk = tr.durations("enc.ctu_walk")
    threads = tr.counter("enc.wpp.threads")
    busy = tr.counter("enc.wpp.ctu_ns")
    pics = [r for r in walk if r in threads]
    den = sum(threads[r] * walk[r] for r in pics)
    if den <= 0:
        return None
    return 100.0 * sum(busy.get(r, 0) for r in pics) / den
