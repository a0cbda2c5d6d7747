"""The decode kernels' share of their bound, in %: every launch's bound
(hevc_bench/bounds/, from the call's own arguments) summed, over the same
launches' device time from torch.profiler, in the profiled part of a
traced decode (stage trace off)."""
from hevc_bench.harness import roofline_share

KERNELS = ("mc_block_grid", "dequant_idct", "deblock", "sao")


def read(run):
    if "dec.picture" not in run.spans:
        return None
    return roofline_share(run, KERNELS)
