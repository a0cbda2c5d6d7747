"""Share of the profiled part of a traced decode in which no kernel, copy
or fill ran on the card, in %."""
from hevc_bench.harness import idle_share


def read(run):
    if "dec.picture" not in run.spans:
        return None
    return idle_share(run)
