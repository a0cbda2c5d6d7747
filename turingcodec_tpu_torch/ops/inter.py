"""Batched fractional-sample interpolation: the decoder's motion
compensation over a whole picture's min-blocks (device twin of
decode/inter_pred.py; havoc/pred_inter.cpp parity).

`mc_block_grid` replaces the XLA program
`turingcodec_tpu/ops/inter.py::mc_block_grid` with the CUDA kernel in
`csrc/mc_block_grid.cu` (its header states the design and what bounds it on
an H100). `mc_block_grid_ref` is the plain torch version of the same
function: the wrapper takes it for CPU tensors, and the kernel is held
against it on the card.

`interp_luma_all_phases` gives all 16 quarter-sample phases of a batch of
luma windows (the encoder side's sub-sample refinement): CUDA tensors
launch `csrc/interp_all_phases.cu`, which replaces the int32 einsums of
`turingcodec_tpu/ops/inter.py::interp_luma_all_phases`; CPU tensors take
the plain torch version `interp_luma_all_phases_ref`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from turingcodec_tpu_torch.hevc.tables import CHROMA_FILTER, LUMA_FILTER
from turingcodec_tpu_torch.ops import kernel_build

# kernel launches since import (or since a caller reset it to 0):
# mc_block_grid's, and interp_luma_all_phases's
launches = 0
interp_launches = 0
# what one launch takes (csrc kMaxGroups, kMaxPlanes): up to 4 (list,
# component) groups and 64 reference planes in all (2 lists x 2 chroma
# components x 16, the most an HEVC list holds)
MAX_GROUPS = 4
MAX_PLANES = 64

_LAUNCH = None
_INTERP_LAUNCH = None


def _filter_on(taps: int, device) -> torch.Tensor:
    """The (phases, taps) int32 filter table on `device`."""
    return kernel_build.table(LUMA_FILTER if taps == 8 else CHROMA_FILTER,
                              device)


def _check(planes, per_block, bs, taps):
    """planes as nested lists [list][component][reference], and
    (L, C, H, W, B); raises on anything the kernel does not take."""
    if (bs, taps) not in ((4, 8), (2, 4)):
        raise ValueError(f"(bs, taps) = {(bs, taps)} unsupported")
    lists = [[list(c) for c in lst] for lst in planes]
    n_l = len(lists)
    n_c = len(lists[0]) if lists else 0
    groups = [c for lst in lists for c in lst]
    if (not n_c or any(len(lst) != n_c for lst in lists)
            or not all(groups)):
        raise ValueError("planes must be L >= 1 lists of C >= 1 components "
                         "of R >= 1 reference planes each")
    if n_l * n_c > MAX_GROUPS or sum(map(len, groups)) > MAX_PLANES:
        raise ValueError(f"at most {MAX_GROUPS} (list, component) groups "
                         f"and {MAX_PLANES} planes in one call")
    first = groups[0][0]
    for p in (p for c in groups for p in c):
        if p.dtype != torch.int16 or p.dim() != 2 or p.shape != first.shape:
            raise TypeError(f"planes must be (H, W) int16 of one size, got "
                            f"{p.dtype} {tuple(p.shape)}")
        if p.device != first.device or not p.is_contiguous():
            raise ValueError("planes must be contiguous, on one device")
    b = per_block[0].shape[-1]
    for a in per_block:
        if a.device != first.device:
            raise ValueError(f"planes on {first.device}, a block array on "
                             f"{a.device}")
        if a.dtype != torch.int32 or a.shape != (n_l, b):
            raise TypeError(f"block arrays must be ({n_l}, B) int32, got "
                            f"{a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError("contiguous block arrays required")
    return lists, (n_l, n_c, *first.shape, b)


def _mc_one(refs, ref_sel, xi, yi, xf, yf, bs, taps, bit_depth):
    """The plain version for one (R, H, W) stack of reference planes."""
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


def mc_block_grid_ref(planes, ref_sel: torch.Tensor, xi: torch.Tensor,
                      yi: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                      bs: int, taps: int, bit_depth: int = 8) -> torch.Tensor:
    """Plain torch version: per list and component, the clamped window
    gather from the stacked planes, then the separable filter with the four
    phase cases, in int32."""
    lists, _ = _check(planes, (ref_sel, xi, yi, xf, yf), bs, taps)
    return torch.stack([torch.stack([
        _mc_one(torch.stack(c), ref_sel[l], xi[l], yi[l], xf[l], yf[l], bs,
                taps, bit_depth) for c in lst])
        for l, lst in enumerate(lists)])


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("mc_block_grid").mc_block_grid_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
        _LAUNCH = fn
    return _LAUNCH


def mc_block_grid(planes, ref_sel: torch.Tensor, xi: torch.Tensor,
                  yi: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                  bs: int, taps: int, bit_depth: int = 8) -> torch.Tensor:
    """Per-block single-phase MC of L reference lists and C components.

    planes: L lists, each of C components (luma alone, or Cb and Cr), each
    a sequence of the list's R (H, W) int16 reference planes (an (R, H, W)
    tensor is such a sequence), all of one size; L * C <= MAX_GROUPS and
    MAX_PLANES planes in all. Per-block (L, B) int32 arrays, one row per
    list: ref_sel index into R, xi/yi the integer top-left sample position
    (mv integer part applied; the reads clamp, which is the spec's edge
    extension), xf/yf the fractional phase. (bs, taps) is (4, 8) for luma
    or (2, 4) for chroma. Returns (L, C, B, bs, bs) int32 14-bit
    intermediate predictions, bit-exact with decode.inter_pred.interp_luma/
    interp_chroma per block. CPU tensors take the plain version; CUDA
    tensors launch the kernel (one launch for every list and component),
    and a failed build or launch raises."""
    global launches
    lists, (n_l, n_c, hh, ww, b) = _check(
        planes, (ref_sel, xi, yi, xf, yf), bs, taps)
    dev = lists[0][0][0].device
    if dev.type == "cpu":
        return mc_block_grid_ref(lists, ref_sel, xi, yi, xf, yf, bs, taps,
                                 bit_depth)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((n_l, n_c, b, bs, bs), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    filt = _filter_on(taps, dev)
    # the planes' addresses go to the kernel by value; `lists` keeps the
    # tensors alive until the launch is enqueued, the stream orders the rest
    groups = [c for lst in lists for c in lst]
    ptrs = [p.data_ptr() for c in groups for p in c]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    counts = (ctypes.c_int * len(groups))(*map(len, groups))
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(table, counts, n_l, n_c, hh, ww, ref_sel.data_ptr(),
                xi.data_ptr(), yi.data_ptr(), xf.data_ptr(), yf.data_ptr(),
                filt.data_ptr(), b, bs, bit_depth, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mc_block_grid launch failed: CUDA error {rc}")
    launches += 1
    return out


def _check_interp(win: torch.Tensor, w: int, h: int, bit_depth: int):
    if win.dtype != torch.int16:
        raise TypeError(f"int16 windows required, got {win.dtype}")
    if win.dim() != 3 or tuple(win.shape[1:]) != (h + 7, w + 7) \
            or w < 1 or h < 1:
        raise ValueError(f"(B, {h + 7}, {w + 7}) windows required, got "
                         f"{tuple(win.shape)}")
    if not 8 <= bit_depth <= 12:
        raise ValueError(f"bit depth {bit_depth} unsupported")
    if not win.is_contiguous():
        raise ValueError("contiguous windows required")


def interp_luma_all_phases_ref(win: torch.Tensor, w: int, h: int,
                               bit_depth: int = 8) -> torch.Tensor:
    """Plain torch version of interp_luma_all_phases: the horizontal pass
    at the four x phases over every window row, the vertical pass at the
    four y phases over those, then the three exact-phase patches, in
    int32."""
    _check_interp(win, w, h, bit_depth)
    shift1 = bit_depth - 8
    shift3 = 14 - bit_depth
    win = win.to(torch.int32)
    f = _filter_on(8, win.device)                      # (4 phases, 8 taps)

    def fir(slices, phase):
        acc = slices(0) * f[phase, 0]
        for k in range(1, 8):
            acc = acc + slices(k) * f[phase, k]
        return acc

    # htmp[:, px]: (B, h + 7, w), the horizontal pass of every row
    htmp = torch.stack([fir(lambda k: win[:, :, k:k + w], p) >> shift1
                        for p in range(4)], 1)
    out = torch.stack([torch.stack([
        fir(lambda k: htmp[:, px, k:k + h], py) >> 6 for px in range(4)], 1)
        for py in range(4)], 1)                        # (B, 4y, 4x, h, w)
    # the exact-phase cases: (0, x > 0) H only, (y > 0, 0) V only, (0, 0)
    out[:, 0] = htmp[:, :, 3:3 + h]
    out[:, :, 0] = torch.stack([
        fir(lambda k: win[:, k:k + h, 3:3 + w], py) >> shift1
        for py in range(4)], 1)
    out[:, 0, 0] = win[:, 3:3 + h, 3:3 + w] << shift3
    return out


def _interp_launcher():
    global _INTERP_LAUNCH
    if _INTERP_LAUNCH is None:
        fn = kernel_build.load("interp_all_phases").interp_all_phases_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        _INTERP_LAUNCH = fn
    return _INTERP_LAUNCH


def interp_luma_all_phases(win: torch.Tensor, w: int, h: int,
                           bit_depth: int = 8) -> torch.Tensor:
    """(B, h+7, w+7) int16 windows -> (B, 4, 4, h, w) int32 14-bit
    predictions of the block at the window's (3, 3) for every (yfrac,
    xfrac) quarter-sample phase, bit-exact with decode.inter_pred.
    interp_luma per phase; bit depths 8..12. CPU tensors take the plain
    version; CUDA tensors launch the kernel once, and a failed build or
    launch raises."""
    global interp_launches
    _check_interp(win, w, h, bit_depth)
    if win.device.type == "cpu":
        return interp_luma_all_phases_ref(win, w, h, bit_depth)
    if win.device.type != "cuda":
        raise ValueError(f"unsupported device {win.device}")
    b = win.shape[0]
    out = torch.empty((b, 4, 4, h, w), dtype=torch.int32, device=win.device)
    if b == 0:
        return out
    filt = _filter_on(8, win.device)
    fn = _interp_launcher()
    stream = torch.cuda.current_stream(win.device).cuda_stream
    with torch.cuda.device(win.device):
        rc = fn(win.data_ptr(), filt.data_ptr(), b, w, h, bit_depth,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"interp_all_phases launch failed: CUDA error "
                           f"{rc}")
    interp_launches += 1
    return out


def interp_luma_all_phases_np(win: np.ndarray, w: int, h: int,
                              bit_depth: int = 8) -> np.ndarray:
    """numpy oracle via the scalar decoder op on an inner window."""
    from turingcodec_tpu_torch.decode.inter_pred import interp_luma
    b = win.shape[0]
    out = np.zeros((b, 4, 4, h, w), np.int64)
    for i in range(b):
        # a reference picture whose window sits at (3, 3)
        for fy in range(4):
            for fx in range(4):
                out[i, fy, fx] = interp_luma(win[i], 3, 3, fx, fy, w, h,
                                             bit_depth)
    return out
