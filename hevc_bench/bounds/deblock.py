"""deblock: chip_smoke.py::deblock_bound, commit dd78b9c.

The three int16 planes read once and written once, every map and
per-slice vector read once; 20 INT32 operations per 4-line edge segment
of the two directions for its edge flag and bS."""
from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "deblock_kernel"
CALLS = (("turingcodec_tpu_torch.ops.deblock", "deblock_frames"),)


def bound(args, kwargs):
    planes, maps, sl = args[:3], args[3], args[4]
    h, w = planes[0].shape[-2:]
    f = planes[0].shape[0]
    segments = f * ((w // 8 - 1) * (h // 4) + (h // 8 - 1) * (w // 4))
    nbytes = (2 * sum(p.nbytes for p in planes)
              + sum(t.nbytes for t in tuple(maps) + tuple(sl)))
    return _bound(nbytes, 20 * segments)
