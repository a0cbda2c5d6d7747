"""Batched fractional-sample interpolation: the decoder's motion
compensation over a whole picture's min-blocks (device twin of
decode/inter_pred.py; havoc/pred_inter.cpp parity).

`mc_block_grid` replaces the XLA program
`turingcodec_tpu/ops/inter.py::mc_block_grid` with the CUDA kernel in
`csrc/mc_block_grid.cu` (its header states the design and what bounds it on
an H100). `mc_block_grid_ref` is the plain torch version of the same
function: the wrapper takes it for CPU tensors, and the kernel is held
against it on the card.

`mc_picture` is the decoder pipeline's whole MC stage in one launch of the
same file's `mc_picture_kernel`, straight from the plan's dense maps into
the picture's planes. It replaces the host glue of
`turingcodec_tpu/decode/device_pipeline.py::_mc_device` as the port ran it
(`_predict`'s host gather and upload of every block's motion, two
`mc_block_grid` launches into int32 blocks, `_combine_uni_bi`'s dozen
elementwise launches a component and `_scatter_blocks`' three index_put
scatters): about 13 ms of host time a 1080p picture around a 10 us
kernel. The kernel itself is bound by its INT32 multiply-adds or its bytes
(maps, referenced planes, samples out; the source's header counts them);
its design keeps both lists' predictions in registers until the combine and
stores int16 rows in place, so nothing but the samples goes to memory.
`mc_picture_ref` composes `mc_block_grid_ref`, `_combine_uni_bi` and
`_scatter_blocks` over the same maps.

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
# mc_block_grid's, mc_picture's and interp_luma_all_phases's
launches = 0
picture_launches = 0
interp_launches = 0
# what one launch takes (csrc kMaxGroups, kMaxPlanes, kMaxRefs): up to 4
# (list, component) groups and 64 reference planes in all (2 lists x 2
# chroma components x 16, the most an HEVC list holds); mc_picture takes 16
# references a list
MAX_GROUPS = 4
MAX_PLANES = 64
MAX_REFS = 16

_LAUNCH = None
_PICTURE_LAUNCH = None
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


def _combine_uni_bi(p0, p1, on0, on1, bd):
    """Default weighted sample prediction from 14-bit parts (8.5.3.3.4.2).
    A list no block uses comes as None: every block then predicts from the
    other list alone; with neither it combines nothing (None). The rounding
    term is a Python shift, so at 14 bits and above this raises
    ValueError("negative shift count"), as the reference pipeline does
    (a trait the port keeps: mc_picture checks depths through it)."""
    shift = 14 - bd
    half = 1 << (shift - 1)
    if p0 is None and p1 is None:
        return None
    if p0 is None or p1 is None:
        p = p1 if p0 is None else p0
        return ((p + half) >> shift).clamp(0, (1 << bd) - 1)
    bi = (p0 + p1 + (1 << shift)) >> (shift + 1)
    uni0 = (p0 + half) >> shift
    uni1 = (p1 + half) >> shift
    on0 = on0[:, None, None]
    on1 = on1[:, None, None]
    v = torch.where(on0 & on1, bi, torch.where(on0, uni0, uni1))
    return v.clamp(0, (1 << bd) - 1)


def _scatter_blocks(plane, by, bx, blocks, bs):
    """Scatter disjoint bs-aligned (B, bs, bs) blocks at min-block coords
    (by, bx) into the (H, W) plane, in place; returns the plane."""
    h, w = plane.shape
    pr = plane.view(h // bs, bs, w // bs, bs).permute(0, 2, 1, 3)
    pr[by.long(), bx.long()] = blocks.to(plane.dtype)
    return plane


def _check_picture(planes, refs, inter, ref_idx, mv, bit_depths):
    """Raises on anything mc_picture does not take; returns (h4, w4)."""
    for bd in bit_depths:
        _combine_uni_bi(None, None, None, None, bd)
        if not 8 <= bd <= 13:
            raise ValueError(f"bit depth {bd} unsupported")
    if len(planes) != 3 or inter.dim() != 2:
        raise ValueError("planes must be [y, cb, cr] and inter (h4, w4)")
    h4, w4 = inter.shape
    dev = planes[0].device
    arrays = list(zip(planes, [torch.int16] * 3,
                      [(4 * h4, 4 * w4)] + [(2 * h4, 2 * w4)] * 2))
    arrays += [(inter, torch.uint8, (h4, w4)),
               (ref_idx, torch.int8, (2, h4, w4)),
               (mv, torch.int16, (2, h4, w4, 2))]
    if len(refs) != 2 or any(len(lst) > MAX_REFS for lst in refs):
        raise ValueError(f"refs must be 2 lists of at most {MAX_REFS} "
                         f"reference pictures")
    for lst in refs:
        for pic in lst:
            if len(pic) != 3:
                raise ValueError("a reference picture is (y, cb, cr)")
            arrays += [(p, torch.int16, tuple(q.shape))
                       for p, q in zip(pic, planes)]
    for a, dtype, shape in arrays:
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise TypeError(f"{dtype} {shape} required, got {a.dtype} "
                            f"{tuple(a.shape)}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError("contiguous tensors on one device required")
    return h4, w4


def mc_picture_ref(planes, refs, inter: torch.Tensor, ref_idx: torch.Tensor,
                   mv: torch.Tensor, bit_depths) -> list:
    """Plain torch version of mc_picture: the predicted blocks' motion
    gathered from the maps, mc_block_grid_ref per component over the lists
    some block uses, the combine and the scatter into the planes."""
    _check_picture(planes, refs, inter, ref_idx, mv, bit_depths)
    by, bx = torch.nonzero((inter != 0) & (ref_idx >= 0).any(0),
                           as_tuple=True)
    if not len(by):
        return planes
    used = [lx for lx in (0, 1) if bool((ref_idx[lx, by, bx] >= 0).any())]
    r = ref_idx[used][:, by, bx].to(torch.int32)          # (L, B)
    m = mv[used][:, by, bx].to(torch.int32)               # (L, B, 2)
    on = dict(zip(used, r >= 0))
    sel = r.clamp(min=0)
    bd_y, bd_c = bit_depths
    for c, (plane, bs, taps, bd) in enumerate(zip(
            planes, (4, 2, 2), (8, 4, 4), (bd_y, bd_c, bd_c))):
        sh = 2 if bs == 4 else 3     # 1/4-sample luma, 1/8 4:2:0 chroma
        frac = (1 << sh) - 1
        p14 = mc_block_grid_ref(
            [[[pic[c] for pic in refs[lx]]] for lx in used], sel,
            bx.int() * bs + (m[..., 0] >> sh),
            by.int() * bs + (m[..., 1] >> sh), m[..., 0] & frac,
            m[..., 1] & frac, bs, taps, bd)[:, 0]
        parts = dict(zip(used, p14))
        _scatter_blocks(plane, by, bx, _combine_uni_bi(
            parts.get(0), parts.get(1), on.get(0), on.get(1), bd), bs)
    return planes


def _picture_launcher():
    global _PICTURE_LAUNCH
    if _PICTURE_LAUNCH is None:
        fn = kernel_build.load("mc_block_grid").mc_picture_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 4)
        _PICTURE_LAUNCH = fn
    return _PICTURE_LAUNCH


def mc_picture(planes, refs, inter: torch.Tensor, ref_idx: torch.Tensor,
               mv: torch.Tensor, bit_depths) -> list:
    """The whole MC stage of a 4:2:0 picture of (h4, w4) min-blocks, into
    its planes, in place.

    planes: [y, cb, cr] int16, (4 h4, 4 w4) and (2 h4, 2 w4); refs: two
    lists (list 0, list 1) of at most MAX_REFS (y, cb, cr) reference
    pictures of the same shapes; inter: (h4, w4) uint8; ref_idx: (2, h4, w4)
    int8, -1 where a list is unused; mv: (2, h4, w4, 2) int16, (x, y) in
    quarter luma samples; bit_depths (luma, chroma), 8..13 (14 and above
    raise the reference's ValueError("negative shift count") from
    _combine_uni_bi). A block where inter is nonzero and some list's
    ref_idx is >= 0 is predicted from each such list (its index clamped
    into the list, every read clamped into the plane), combined by the
    default weighted prediction, clipped to the bit depth and written to
    the three planes; every other sample is left as it was. A list that
    some predicted block uses must hold a reference. Returns planes. CPU
    tensors take the plain version; CUDA tensors launch the kernel once,
    and a failed build or launch raises."""
    global picture_launches
    h4, w4 = _check_picture(planes, refs, inter, ref_idx, mv, bit_depths)
    dev = planes[0].device
    if dev.type == "cpu":
        return mc_picture_ref(planes, refs, inter, ref_idx, mv, bit_depths)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if mv.data_ptr() % 4:
        raise ValueError("mv must start at a 4-byte boundary")
    # the planes' addresses go to the kernel by value; `refs` keeps the
    # tensors alive until the launch is enqueued, the stream orders the rest
    ptrs = [p.data_ptr() for lst in refs for pic in lst for p in pic]
    table = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    counts = (ctypes.c_int * 2)(*map(len, refs))
    fn = _picture_launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(table, counts, h4, w4, inter.data_ptr(), ref_idx.data_ptr(),
                mv.data_ptr(), _filter_on(8, dev).data_ptr(),
                _filter_on(4, dev).data_ptr(), *bit_depths,
                *(p.data_ptr() for p in planes), stream)
    if rc != 0:
        raise RuntimeError(f"mc_picture launch failed: CUDA error {rc}")
    picture_launches += 1
    return planes


def _check_interp(win: torch.Tensor, w: int, h: int, bit_depth: int):
    if win.dtype != torch.int16:
        raise TypeError(f"int16 windows required, got {win.dtype}")
    if win.dim() != 3 or tuple(win.shape[1:]) != (h + 7, w + 7) \
            or w < 1 or h < 1:
        raise ValueError(f"(B, {h + 7}, {w + 7}) windows required, got "
                         f"{tuple(win.shape)}")
    # 14 - bit_depth is the full-pel phase's left shift: negative above 14
    if not 8 <= bit_depth <= 14:
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
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        _INTERP_LAUNCH = fn
    return _INTERP_LAUNCH


def interp_luma_all_phases(win: torch.Tensor, w: int, h: int,
                           bit_depth: int = 8) -> torch.Tensor:
    """(B, h+7, w+7) int16 windows -> (B, 4, 4, h, w) int32 14-bit
    predictions of the block at the window's (3, 3) for every (yfrac,
    xfrac) quarter-sample phase, bit-exact with decode.inter_pred.
    interp_luma per phase; bit depths 8..14. CPU tensors take the plain
    version; CUDA tensors launch the kernel once (w up to 382), and a
    failed build or launch raises."""
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
    fn = _interp_launcher()
    stream = torch.cuda.current_stream(win.device).cuda_stream
    with torch.cuda.device(win.device):
        rc = fn(win.data_ptr(), b, w, h, bit_depth, out.data_ptr(), stream)
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
