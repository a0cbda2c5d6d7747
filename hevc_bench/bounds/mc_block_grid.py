"""mc_block_grid: chip_smoke.py::mc_bound, commit dd78b9c.

Each distinct reference plane the blocks select read once (by address,
so a picture in both lists counts once), the motion in, every list's and
component's predictions out; one INT32 multiply-add per filter tap the
blocks' phases need (none for full-pel)."""
import torch

from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "mc_block_grid_kernel"
CALLS = (("turingcodec_tpu_torch.decode.device_recon", "mc_block_grid"),)


def bound(args, kwargs):
    planes, sel, _xi, _yi, xf, yf, bs, taps, _bd = args
    span = bs + taps - 1
    b = sel.shape[1]
    nbytes = 5 * 4 * sel.numel()
    ops = 0
    read = {}
    for lx, lst in enumerate(planes):
        used = torch.unique(sel[lx].clamp(0, len(lst[0]) - 1)).tolist()
        for comp in lst:
            for r in used:
                read[comp[r].data_ptr()] = comp[r].nbytes
        fx, fy = xf[lx] != 0, yf[lx] != 0
        one_d = int((fx ^ fy).sum())
        two_d = int((fx & fy).sum())
        nbytes += len(lst) * b * bs * bs * 4
        ops += len(lst) * (one_d * bs * bs * taps
                           + two_d * (span * bs * taps + bs * bs * taps))
    return _bound(nbytes + sum(read.values()), ops)
