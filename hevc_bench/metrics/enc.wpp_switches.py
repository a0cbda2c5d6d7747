"""How often the CTU walk's row threads move rows, per coded picture: the
times a thread took up a CTU row that another thread had left after
coding some of its CTUs (enc.wpp.switches, summed over the walk's
threads), over the trace's enc.docket pictures, in the profiled part of
a traced encode. A program without the counter reads nothing."""
from hevc_bench.program_trace import per_picture, trace


def read(run):
    tr = trace()
    if tr is None or not tr.counter("enc.wpp.switches"):
        return None
    return per_picture(("enc.wpp.switches",), "enc.docket")
