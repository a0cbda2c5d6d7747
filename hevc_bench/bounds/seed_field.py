"""seed_field: chip_smoke.py::seed_bound, commit dd78b9c.

One call over n (h, w) int16 pairs: the two planes of each pair in, the
(hb, wb, 2) int32 seeds out; per 16x16 block 289 x 16 quarter-res and
25 x 64 half-res absolute differences at one INT32-rate operation each,
and the decimation's 15 adds per quarter-res and 3 per half-res sample of
both planes at half an operation each."""
from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "seed_field_kernel"
CALLS = (("turingcodec_tpu_torch.encode.device_analysis", "seed_field"),)


def block_dims(w: int, h: int):
    lw, lh = -(-w // 4), -(-h // 4)
    return -(-lw // 4), -(-lh // 4)


def seed_bound(n: int, h: int, w: int):
    wb, hb = block_dims(w, h)
    b = n * hb * wb
    lw4, lh4, lw2, lh2 = -(-w // 4), -(-h // 4), -(-w // 2), -(-h // 2)
    dec = 2 * n * (15 * lh4 * lw4 + 3 * lh2 * lw2)
    return _bound(4 * n * h * w + 8 * b, b * (289 * 16 + 25 * 64) + dec / 2)


def bound(args, kwargs):
    orig = args[0]
    n = orig.shape[0] if orig.dim() == 3 else 1
    h, w = orig.shape[-2:]
    return seed_bound(n, h, w)
