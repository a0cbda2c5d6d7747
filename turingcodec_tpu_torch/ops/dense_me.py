"""Dense full-pel motion-estimation sweep: the encoder analysis stage's
one hand-written kernel.

The CUDA kernel in `csrc/dense_me.cu` (its header states the design and
what bounds it on an H100) replaces the Pallas TPU kernel
`turingcodec_tpu/ops/pallas_kernels.py::dense_me_argmin`. Two wrappers
launch it:

- `dense_me_sweep(orig, ref, seeds, w, h, wb, hb, want_surf)`, the
  encoder's entry point, reads the sample planes directly around the
  seeds, and with `want_surf` also returns every block's 17x17 SAD surface
  (the table the encoder's full-pel search reads its aligned probes from);
- `dense_me_argmin(cur, patches)` keeps the Pallas kernel's interface
  (materialised blocks and windows).

`dense_me_argmin_ref` is the plain torch version of the function, and
`dense_me_argmin_ref(*dense_inputs(...))` that of the sweep: the wrappers
take them for CPU tensors, and the kernel is held against them on the card.
"""
from __future__ import annotations

import ctypes

import torch

from turingcodec_tpu_torch.ops import kernel_build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_LAUNCH = None
P = 48  # reference pad of enc_core dense_pad_plane


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicating pad of a 2-D tensor by clamped indexing (any
    integer dtype, any device)."""
    h, w = x.shape
    ys = torch.arange(-top, h + bottom, device=x.device).clamp_(0, h - 1)
    xs = torch.arange(-left, w + right, device=x.device).clamp_(0, w - 1)
    return x[ys[:, None], xs[None, :]]


def dense_inputs(orig, ref, seeds, w, h, wb, hb):
    """The sweep's materialised inputs: (hb*wb, 16, 16) source blocks and
    (hb*wb, 32, 32) windows at seed - 8 over the edge-replicated plane
    padded by P (enc_core dense_pad_plane), both int32 contiguous."""
    dev = orig.device
    cur = edge_pad(orig, 0, hb * 16 - h, 0, wb * 16 - w)
    r = edge_pad(ref, P, hb * 16 - h + P, P, wb * 16 - w + P)
    cb = cur.reshape(hb, 16, wb, 16).permute(0, 2, 1, 3)
    by = torch.arange(hb, device=dev)[:, None]
    bx = torch.arange(wb, device=dev)[None, :]
    a32 = torch.arange(32, device=dev)
    ys = (by * 16 + seeds[:, :, 1] - 8 + P)[:, :, None, None] \
        + a32[None, None, :, None]
    xs = (bx * 16 + seeds[:, :, 0] - 8 + P)[:, :, None, None] \
        + a32[None, None, None, :]
    patch = r[ys, xs]  # (hb, wb, 32, 32)
    return (cb.reshape(hb * wb, 16, 16).to(torch.int32).contiguous(),
            patch.reshape(hb * wb, 32, 32).to(torch.int32).contiguous())


def _check(cur: torch.Tensor, patches: torch.Tensor) -> int:
    if cur.device != patches.device:
        raise ValueError(f"cur on {cur.device}, patches on {patches.device}")
    if cur.dtype != torch.int32 or patches.dtype != torch.int32:
        raise TypeError(f"int32 inputs required, got {cur.dtype}, "
                        f"{patches.dtype}")
    b = cur.shape[0]
    if cur.shape != (b, 16, 16) or patches.shape != (b, 32, 32):
        raise ValueError(f"shapes (B,16,16) and (B,32,32) required, got "
                         f"{tuple(cur.shape)} and {tuple(patches.shape)}")
    if not (cur.is_contiguous() and patches.is_contiguous()):
        raise ValueError("contiguous inputs required")
    return b


def _check_sweep(orig, ref, seeds, w, h, wb, hb) -> None:
    if not (orig.device == ref.device == seeds.device):
        raise ValueError(f"orig on {orig.device}, ref on {ref.device}, "
                         f"seeds on {seeds.device}")
    if orig.dtype not in (torch.int16, torch.int32) or ref.dtype != orig.dtype:
        raise TypeError(f"int16 or int32 planes of one dtype required, got "
                        f"{orig.dtype}, {ref.dtype}")
    if orig.shape != (h, w) or ref.shape != (h, w):
        raise ValueError(f"({h}, {w}) planes required, got "
                         f"{tuple(orig.shape)} and {tuple(ref.shape)}")
    if seeds.dtype != torch.int32 or seeds.shape != (hb, wb, 2):
        raise TypeError(f"seeds must be ({hb}, {wb}, 2) int32, got "
                        f"{seeds.dtype} {tuple(seeds.shape)}")
    if -(-w // 16) > wb or -(-h // 16) > hb:
        raise ValueError(f"a {wb}x{hb} block grid does not cover {w}x{h}")
    if not all(a.is_contiguous() for a in (orig, ref, seeds)):
        raise ValueError("contiguous inputs required")


def dense_me_argmin_ref(cur: torch.Tensor, patches: torch.Tensor,
                        want_surf: bool = False):
    """Plain torch version: all 289 window SADs, then the min of the packed
    key (cost << 9) | k with k = oy * 17 + ox, whose ties resolve to the
    first offset in (oy, ox) scan order. With want_surf, also the (B, 289)
    int32 SADs themselves."""
    b = _check(cur, patches)
    win = patches.unfold(1, 16, 1).unfold(2, 16, 1)   # (B, 17, 17, 16, 16)
    c = cur[:, None]
    # one window row at a time keeps the (B, 17, 16, 16) difference small
    sad = torch.stack([(c - win[:, oy]).abs().sum((-2, -1))
                       for oy in range(17)], 1).reshape(b, 289)
    a = torch.arange(17, device=cur.device) - 8
    pen = (a[:, None].abs() + a[None, :].abs()).reshape(289)
    k = torch.arange(289, device=cur.device)
    key = (((sad << 2) + pen) << 9) | k
    kbest = key.min(1).values & 511
    res = torch.stack([kbest % 17 - 8, kbest // 17 - 8,
                       sad.gather(1, kbest[:, None])[:, 0]],
                      1).to(torch.int32)
    return (res, sad.to(torch.int32)) if want_surf else res


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("dense_me").dense_me_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3)
        _LAUNCH = fn
    return _LAUNCH


def _launch(src, src_hw, ref, ref_hw, seeds, wb, b, want_surf=False):
    """One kernel launch over contiguous planes on a CUDA device; returns
    the (b, 3) winners, and the (b, 289) surface with want_surf."""
    global launches
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    out = torch.empty((b, 3), dtype=torch.int32, device=src.device)
    surf = (torch.empty((b, 289), dtype=torch.int32, device=src.device)
            if want_surf else None)
    if b == 0:
        return (out, surf) if want_surf else out
    fn = _launcher()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), src_hw[1], src_hw[0], src_hw[1],
                ref.data_ptr(), ref_hw[1], ref_hw[0], ref_hw[1],
                None if seeds is None else seeds.data_ptr(), wb, b,
                src.element_size(), out.data_ptr(),
                None if surf is None else surf.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dense_me launch failed: CUDA error {rc}")
    launches += 1
    return (out, surf) if want_surf else out


def dense_me_argmin(cur: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """For each block, the (ox, oy) in [-8, 8]^2 minimising
    (SAD(cur, patches[oy+8:oy+24, ox+8:ox+24]) << 2) + |ox| + |oy|, ties to
    the first offset in (oy, ox) scan order.

    cur: (B, 16, 16) int32 source blocks; patches: (B, 32, 32) int32
    reference windows at seed - 8; samples of at most 12 bits. Returns
    (B, 3) int32 [ox, oy, sad]. CPU tensors take the plain version; CUDA
    tensors launch the kernel, and a failed build or launch raises."""
    b = _check(cur, patches)
    if cur.device.type == "cpu":
        return dense_me_argmin_ref(cur, patches)
    return _launch(cur, (16 * b, 16), patches, (32 * b, 32), None, 1, b)


def dense_me_sweep(orig: torch.Tensor, ref: torch.Tensor,
                   seeds: torch.Tensor, w: int, h: int, wb: int, hb: int,
                   want_surf: bool = False):
    """Twin of enc_core dense_search_rows: dense_me_argmin over every
    16x16 block of the wb x hb grid, read straight from the planes.

    orig, ref: (h, w) int16 or int32 sample planes of at most 12 bits;
    seeds: (hb, wb, 2) int32 [sx, sy] full-pel seeds. Block (by, bx) is
    the source at (16 by, 16 bx) and the window at (16 by + sy - 8,
    16 bx + sx - 8), both with every coordinate clamped into the planes
    (the edge replication of dense_inputs). Returns (hb*wb, 3) int32
    [ox, oy, sad]; with want_surf, that and the (hb*wb, 289) int32 SAD
    surface, k = oy * 17 + ox for the offset (ox - 8, oy - 8). CPU tensors
    take the plain version; CUDA tensors launch the kernel, and a failed
    build or launch raises."""
    _check_sweep(orig, ref, seeds, w, h, wb, hb)
    if orig.device.type == "cpu":
        return dense_me_argmin_ref(*dense_inputs(orig, ref, seeds, w, h, wb,
                                                 hb), want_surf)
    return _launch(orig, (h, w), ref, (h, w), seeds, wb, hb * wb, want_surf)
