"""dense_me: chip_smoke.py::dense_bound, commit dd78b9c.

One sweep over b 16x16 blocks: 289 x 256 absolute differences per block at
one INT32 operation each; the two planes in, the seeds in and [ox, oy,
sad] out, and the 289 int32 SADs per block with the surface."""
from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "dense_me_kernel"
CALLS = (("turingcodec_tpu_torch.encode.device_analysis", "dense_me_sweep"),)


def dense_bound(b: int, plane_bytes: int, surf: bool = False):
    return _bound(2 * plane_bytes + 8 * b + 12 * b
                  + (4 * 289 * b if surf else 0), 289 * 256 * b)


def bound(args, kwargs):
    orig, wb, hb = args[0], args[5], args[6]
    surf = bool(args[7]) if len(args) > 7 else bool(
        kwargs.get("want_surf", False))
    return dense_bound(hb * wb, orig.numel() * orig.element_size(), surf)
