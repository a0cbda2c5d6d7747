"""rank_satd: chip_smoke.py::rank_ops and rank_bound, commit dd78b9c.

Per sample of each block and mode: the angular prediction's two
multiply-adds and a shift, planar's four multiply-adds and a shift, DC
none; the difference, the two butterfly passes (6 adds for 8x8
sub-blocks, 4 for 4x4; a packed pair of modes counted once where the
samples fit 9 bits for 8x8 and 11 for 4x4) and the absolute value and
sum. The int16 plane and the int32 z-scan table in once, the
(h/n, w/n, 35) int32 tables out. One call launches once per size."""
from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "rank_satd_kernel"
CALLS = (("turingcodec_tpu_torch.encode.device_analysis",
          "rank_satd_tables"),)
SIZES = (4, 8, 16, 32)


def rank_ops(h: int, w: int, bd: int, sizes=SIZES) -> int:
    ops = 0
    for n in sizes:
        samples = (h // n) * (w // n) * n * n
        sb = 8 if n >= 8 else 4
        fly = 6 if sb == 8 else 4
        packed = bd <= (9 if sb == 8 else 11)
        ops += samples * (33 * 3 + 5 + 35 * (1 + 2)
                          + 35 * fly / (2 if packed else 1))
    return int(ops)


def rank_bound(h: int, w: int, bd: int, sizes=SIZES):
    tables = sum((h // n) * (w // n) * 35 * 4 for n in sizes)
    return _bound(2 * h * w + 4 * (h // 4) * (w // 4) + tables,
                  rank_ops(h, w, bd, sizes))


def bound(args, kwargs):
    plane, bd = args[0], args[2]
    sizes = args[4] if len(args) > 4 else kwargs.get("sizes", SIZES)
    h, w = plane.shape
    return rank_bound(h, w, bd, [n for n in sizes if h // n and w // n])
