"""sao: chip_smoke.py::sao_bound, commit dd78b9c.

Each int16 plane of the call read once and written once, the per-CTB
maps, per-slice flags and skip map read once; 10 INT32 operations per
sample (the band or edge index, the offset and the clip)."""
from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "sao_kernel"
CALLS = (("turingcodec_tpu_torch.ops.sao", "sao_picture_frames"),)


def bound(args, kwargs):
    planes = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
    maps = [a for a in args[4:] if hasattr(a, "nbytes")]
    return _bound(2 * sum(p.nbytes for p in planes)
                  + sum(a.nbytes for a in maps),
                  10 * sum(p.numel() for p in planes))
