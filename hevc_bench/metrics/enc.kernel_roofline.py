"""The analysis kernels' share of their bound, in %: every launch's bound
(hevc_bench/bounds/, from the call's own arguments) summed, over the same
launches' device time from torch.profiler, in the profiled part of a
traced encode (stage spans off)."""
from hevc_bench.harness import roofline_share

KERNELS = ("seed_field", "dense_me", "subpel_planes", "rank_satd")


def read(run):
    if "enc.picture" not in run.spans:
        return None
    return roofline_share(run, KERNELS)
