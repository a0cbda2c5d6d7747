"""Batched fractional-sample interpolation: the decoder's motion
compensation over a whole picture's min-blocks (device twin of
decode/inter_pred.py; havoc/pred_inter.cpp parity).

`mc_block_grid` replaces the XLA program
`turingcodec_tpu/ops/inter.py::mc_block_grid` with the CUDA kernel in
`csrc/mc_block_grid.cu` (its header states the design and what bounds it on
an H100). `mc_block_grid_ref` is the plain torch version of the same
function: the wrapper takes it for CPU tensors, and the kernel is held
against it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from turingcodec_tpu_torch.hevc.tables import CHROMA_FILTER, LUMA_FILTER
from turingcodec_tpu_torch.ops import kernel_build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_LAUNCH = None


def _filter_on(taps: int, device) -> torch.Tensor:
    """The (phases, taps) int32 filter table on `device`."""
    return kernel_build.table(LUMA_FILTER if taps == 8 else CHROMA_FILTER,
                              device)


def _check(refs, per_block, bs, taps) -> int:
    if (bs, taps) not in ((4, 8), (2, 4)):
        raise ValueError(f"(bs, taps) = {(bs, taps)} unsupported")
    if refs.dtype != torch.int16 or refs.dim() != 3:
        raise TypeError(f"refs must be (R, H, W) int16, got "
                        f"{refs.dtype} {tuple(refs.shape)}")
    b = per_block[0].shape[0]
    for a in per_block:
        if a.device != refs.device:
            raise ValueError(f"refs on {refs.device}, a block array on "
                             f"{a.device}")
        if a.dtype != torch.int32 or a.shape != (b,):
            raise TypeError(f"block arrays must be (B,) int32, got "
                            f"{a.dtype} {tuple(a.shape)}")
    if not all(a.is_contiguous() for a in (refs, *per_block)):
        raise ValueError("contiguous inputs required")
    return b


def mc_block_grid_ref(refs: torch.Tensor, ref_sel: torch.Tensor,
                      xi: torch.Tensor, yi: torch.Tensor, xf: torch.Tensor,
                      yf: torch.Tensor, bs: int, taps: int,
                      bit_depth: int = 8) -> torch.Tensor:
    """Plain torch version: clamped window gather, then the separable
    filter with the four phase cases, in int32."""
    _check(refs, (ref_sel, xi, yi, xf, yf), bs, taps)
    dev = refs.device
    shift1 = bit_depth - 8
    shift3 = 14 - bit_depth
    off = taps // 2 - 1
    span = bs + taps - 1
    r, hh, ww = refs.shape
    filt = _filter_on(taps, dev)
    phases = filt.shape[0]
    ar = torch.arange(span, device=dev)
    ys = (yi.long()[:, None] - off + ar).clamp(0, hh - 1)
    xs = (xi.long()[:, None] - off + ar).clamp(0, ww - 1)
    sel = ref_sel.long().clamp(0, r - 1)
    win = refs[sel[:, None, None], ys[:, :, None],
               xs[:, None, :]].to(torch.int32)           # (B, span, span)
    fh = filt[xf.long().clamp(0, phases - 1)]              # (B, taps)
    fv = filt[yf.long().clamp(0, phases - 1)]

    def fir(slices, f):
        acc = torch.zeros_like(slices(0))
        for k in range(taps):
            acc += slices(k) * f[:, k, None, None]
        return acc

    htmp = fir(lambda k: win[:, :, k:k + bs], fh) >> shift1  # (B, span, bs)
    out2d = fir(lambda k: htmp[:, k:k + bs, :], fv) >> 6
    h_only = htmp[:, off:off + bs, :]
    v_only = fir(lambda k: win[:, k:k + bs, off:off + bs], fv) >> shift1
    center = win[:, off:off + bs, off:off + bs] << shift3
    zx = (xf == 0)[:, None, None]
    zy = (yf == 0)[:, None, None]
    return torch.where(zx & zy, center,
                       torch.where(zy, h_only,
                                   torch.where(zx, v_only, out2d)))


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("mc_block_grid").mc_block_grid_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
        _LAUNCH = fn
    return _LAUNCH


def mc_block_grid(refs: torch.Tensor, ref_sel: torch.Tensor,
                  xi: torch.Tensor, yi: torch.Tensor, xf: torch.Tensor,
                  yf: torch.Tensor, bs: int, taps: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """Per-block single-phase MC over stacked reference planes.

    refs: (R, H, W) int16; per-block (B,) int32 arrays: ref_sel index into
    R, xi/yi the integer top-left sample position (mv integer part applied;
    the gather clamps, which is the spec's edge extension), xf/yf the
    fractional phase. (bs, taps) is (4, 8) for luma or (2, 4) for chroma.
    Returns (B, bs, bs) int32 14-bit intermediate predictions, bit-exact
    with decode.inter_pred.interp_luma/interp_chroma per block. CPU tensors
    take the plain version; CUDA tensors launch the kernel, and a failed
    build or launch raises."""
    global launches
    b = _check(refs, (ref_sel, xi, yi, xf, yf), bs, taps)
    if refs.device.type == "cpu":
        return mc_block_grid_ref(refs, ref_sel, xi, yi, xf, yf, bs, taps,
                                 bit_depth)
    if refs.device.type != "cuda":
        raise ValueError(f"unsupported device {refs.device}")
    out = torch.empty((b, bs, bs), dtype=torch.int32, device=refs.device)
    if b == 0:
        return out
    r, hh, ww = refs.shape
    filt = _filter_on(taps, refs.device)
    fn = _launcher()
    stream = torch.cuda.current_stream(refs.device).cuda_stream
    with torch.cuda.device(refs.device):
        rc = fn(refs.data_ptr(), r, hh, ww, ref_sel.data_ptr(),
                xi.data_ptr(), yi.data_ptr(), xf.data_ptr(), yf.data_ptr(),
                filt.data_ptr(), b, bs, bit_depth, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mc_block_grid launch failed: CUDA error {rc}")
    launches += 1
    return out
