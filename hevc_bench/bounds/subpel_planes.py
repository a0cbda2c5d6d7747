"""subpel_planes: chip_smoke.py::subpel_bound, commit dd78b9c.

One call on an (h, w) plane: the int16 plane in, the (15, h + 56, w + 56)
int16 planes out; the three horizontal phases' 8 taps over the h + 63
source rows of every output column, and per output sample the three
vertical phases' 8 taps over the plane and over each horizontal phase."""
from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "subpel_planes_kernel"
CALLS = (("turingcodec_tpu_torch.encode.device_analysis", "subpel_planes"),)


def subpel_bound(h: int, w: int):
    ph, pw = h + 56, w + 56
    return _bound(2 * h * w + 15 * 2 * ph * pw,
                  24 * (ph + 7) * pw + 12 * 8 * ph * pw)


def bound(args, kwargs):
    h, w = args[0].shape
    return subpel_bound(h, w)
