"""HEVC transforms: the batched forward transform with its CUDA kernel
(and the numpy one the host encoder needs), and the decoder's inverse
transform as torch code with its CUDA kernel.

`forward_transform_batch` transforms a (B, N, N) batch of residual blocks
of one size: CUDA tensors launch `csrc/fwd_transform.cu`, which replaces
the int32 einsums of `turingcodec_tpu/ops/transform.py::
forward_transform_batch`; CPU tensors take the plain torch version
`forward_transform_batch_ref`.

`dequant_idct_add` is the decoder's residual stage for one picture: for
every coded inter TU of all three components it dequantizes the levels
(ops/quant.py), runs the two-stage inverse DCT, the transform-skip shift or
transquant bypass, and adds the result to the predicted samples with a
clip, in place. CUDA tensors launch the hand-written kernel
`csrc/dequant_idct.cu` once; it replaces the int32 einsums of
`turingcodec_tpu/ops/transform.py::inverse_transform_batch` with the
quantization and the add/clip around them (torch has no integer matmul on
CUDA, and float32 is not exact here). CPU tensors take the plain torch
version `dequant_idct_add_ref`, which the kernel is held against on the
card.

The TUs come as a table, one int32 row per TU: (x, y) in component
samples, the QP with the bit depth's offset, and a packed kind (component,
log2 size, mode; `tu_kind`). Modes: 0 inverse DCT, 1 transform skip, 2
transquant bypass.

Parity reference: havoc/transform.cpp (all sizes, fwd+inv), spec 8.6.4.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from turingcodec_tpu_torch.hevc.tables import DST4, LEVEL_SCALE, dct2_matrix
from turingcodec_tpu_torch.ops import kernel_build
from turingcodec_tpu_torch.ops.quant import dequant_batch

# kernel launches since import (or since a caller reset it to 0):
# dequant_idct_add's, and forward_transform_batch's
launches = 0
fwd_launches = 0

# TU table columns, and the kind field's layout: mode in bits 0-1, log2
# size in bits 2-4, component in bits 5-6 (csrc/dequant_idct.cu reads it)
TU_X, TU_Y, TU_QP, TU_KIND = range(4)
MODES = (0, 1, 2)
LOG2_SIZES = (2, 3, 4, 5)

_LAUNCH = None
_FWD_LAUNCH = None


def tu_kind(comp, log2, mode):
    """The packed kind field of a TU table row (ints or numpy arrays)."""
    return mode | (log2 << 2) | (comp << 5)


def tu_fields(kind):
    """(comp, log2, mode) of a kind field (ints or numpy arrays)."""
    return kind >> 5, (kind >> 2) & 7, kind & 3


@functools.lru_cache(maxsize=None)
def _matrix(n: int, dst: bool) -> np.ndarray:
    m = DST4 if dst else dct2_matrix(n)
    return np.asarray(m, dtype=np.int32)


def forward_transform_np(res: np.ndarray, bit_depth: int = 8,
                         use_dst: bool = False) -> np.ndarray:
    """numpy oracle for the forward transform (single block, (N, N))."""
    n = res.shape[-1]
    log2n = int(n).bit_length() - 1
    m = _matrix(n, use_dst).astype(np.int64)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    t = res.astype(np.int64) @ m.T
    t = (t + (1 << (shift1 - 1))) >> shift1 if shift1 > 0 else t << -shift1
    c = m @ t
    c = (c + (1 << (shift2 - 1))) >> shift2
    return c.astype(np.int32)


def _check_fwd(res: torch.Tensor, bit_depth: int, use_dst: bool) -> int:
    """Raises on anything the kernel does not take; returns log2 N."""
    if res.dtype != torch.int32:
        raise TypeError(f"int32 residuals required, got {res.dtype}")
    n = res.shape[-1] if res.dim() == 3 else 0
    if res.dim() != 3 or res.shape[1] != n or n not in (4, 8, 16, 32):
        raise ValueError(f"(B, N, N) residuals with N in 4..32 required, "
                         f"got {tuple(res.shape)}")
    if use_dst and n != 4:
        raise ValueError(f"the DST is 4x4 only, got N = {n}")
    if not 8 <= bit_depth <= 12:
        raise ValueError(f"bit depth {bit_depth} unsupported")
    if not res.is_contiguous():
        raise ValueError("contiguous residuals required")
    return n.bit_length() - 1


def forward_transform_batch_ref(res: torch.Tensor, bit_depth: int = 8,
                                use_dst: bool = False) -> torch.Tensor:
    """Plain torch version of forward_transform_batch: the two matrix
    products in float64 (exact: every sum stays below 2^53 for int32
    inputs), each wrapped to int32 as the JAX program's int32 einsum is,
    with the rounding shifts in int32."""
    log2n = _check_fwd(res, bit_depth, use_dst)
    m = kernel_build.table(_matrix(1 << log2n, use_dst),
                           res.device).to(torch.float64)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    # int64 -> int32 keeps the value modulo 2^32, as JAX's int32 einsum
    t = torch.matmul(res.to(torch.float64), m.T).to(torch.int64).to(
        torch.int32)
    t = (t + (1 << (shift1 - 1))) >> shift1
    c = torch.matmul(m, t.to(torch.float64)).to(torch.int64).to(torch.int32)
    return (c + (1 << (shift2 - 1))) >> shift2


def _fwd_launcher():
    global _FWD_LAUNCH
    if _FWD_LAUNCH is None:
        fn = kernel_build.load("fwd_transform").fwd_transform_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        _FWD_LAUNCH = fn
    return _FWD_LAUNCH


def forward_transform_batch(res: torch.Tensor, bit_depth: int = 8,
                            use_dst: bool = False) -> torch.Tensor:
    """(B, N, N) int32 residuals -> (B, N, N) int32 transform coefficients.

    HM-style forward transform (encoder side), N in 4..32 (the DCT) or 4
    (use_dst, the DST), bit depths 8..12: two stages with shift1 = log2 N
    + bit_depth - 9 and shift2 = log2 N + 6, no clip between them. CPU
    tensors take the plain version; CUDA tensors launch the kernel once
    for the batch, and a failed build or launch raises."""
    global fwd_launches
    log2n = _check_fwd(res, bit_depth, use_dst)
    if res.device.type == "cpu":
        return forward_transform_batch_ref(res, bit_depth, use_dst)
    if res.device.type != "cuda":
        raise ValueError(f"unsupported device {res.device}")
    if res.data_ptr() % 16:
        raise ValueError("residuals must be 16-byte aligned")
    out = torch.empty_like(res)
    if res.shape[0] == 0:
        return out
    fn = _fwd_launcher()
    stream = torch.cuda.current_stream(res.device).cuda_stream
    with torch.cuda.device(res.device):
        rc = fn(res.data_ptr(), out.data_ptr(), res.shape[0], log2n,
                int(use_dst), bit_depth, stream)
    if rc != 0:
        raise RuntimeError(f"fwd_transform launch failed: CUDA error {rc}")
    fwd_launches += 1
    return out


def _clip16(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-32768, 32767)


def inverse_transform_batch(d: torch.Tensor, bit_depth: int = 8,
                            use_dst: bool = False) -> torch.Tensor:
    """(B, N, N) int32 dequantized coeffs -> (B, N, N) int32 residual.

    Bit-exact twin of decode.reconstruct.inverse_transform. The products
    run in float64, exact for integers below 2^53 (|d| <= 32768, so every
    stage's sum stays below 2^27); torch has no integer matmul on CUDA."""
    n = d.shape[-1]
    m = kernel_build.table(_matrix(n, use_dst), d.device).to(torch.float64)
    # stage 1 (columns): e[b] = M^T @ d[b]; >> 7; clip
    e = torch.matmul(m.T, d.to(torch.float64)).to(torch.int64)
    g = _clip16((e + 64) >> 7)
    # stage 2 (rows): r[b] = g[b] @ M
    r = torch.matmul(g.to(torch.float64), m).to(torch.int64)
    bd_shift = 20 - bit_depth
    r = (r + (1 << (bd_shift - 1))) >> bd_shift
    return _clip16(r).to(torch.int32)


def _check(levels: torch.Tensor, qp: torch.Tensor, log2_size: int,
           mode: int) -> int:
    if levels.device != qp.device:
        raise ValueError(f"levels on {levels.device}, qp on {qp.device}")
    if levels.dtype != torch.int32 or qp.dtype != torch.int32:
        raise TypeError(f"int32 inputs required, got {levels.dtype}, "
                        f"{qp.dtype}")
    if log2_size not in LOG2_SIZES or mode not in (0, 1):
        raise ValueError(f"log2_size {log2_size} / mode {mode} unsupported")
    n = 1 << log2_size
    b = levels.shape[0]
    if levels.shape != (b, n, n) or qp.shape != (b,):
        raise ValueError(f"shapes (B,{n},{n}) and (B,) required, got "
                         f"{tuple(levels.shape)} and {tuple(qp.shape)}")
    if not (levels.is_contiguous() and qp.is_contiguous()):
        raise ValueError("contiguous inputs required")
    return b


def dequant_inverse_transform_ref(levels: torch.Tensor, qp: torch.Tensor,
                                  bit_depth: int, log2_size: int,
                                  mode: int) -> torch.Tensor:
    """Plain torch version: dequant_batch, then the inverse DCT (mode 0)
    or the transform-skip shift (mode 1, spec 8.6.4.1)."""
    _check(levels, qp, log2_size, mode)
    d = dequant_batch(levels, qp, bit_depth, log2_size)
    if mode == 0:
        return inverse_transform_batch(d, bit_depth, False)
    bds2 = 20 - bit_depth
    return _clip16(((d << 7) + (1 << (bds2 - 1))) >> bds2)


def dequant_inverse_transform(levels: torch.Tensor, qp: torch.Tensor,
                              bit_depth: int, log2_size: int,
                              mode: int) -> torch.Tensor:
    """Residuals of B TUs of one size on the CPU: (B, N, N) int32 levels
    with N = 1 << log2_size and (B,) int32 QP (offset for the bit depth) ->
    (B, N, N) int32. mode 0: flat dequantization, then the two-stage
    inverse DCT; mode 1: dequantization, then the transform-skip shift.
    The card has no per-size kernel: CUDA tensors raise, and the decoder
    calls `dequant_idct_add` for a whole picture instead."""
    _check(levels, qp, log2_size, mode)
    if levels.device.type != "cpu":
        raise ValueError(f"dequant_inverse_transform runs on the CPU only, "
                         f"got {levels.device}: on the card, "
                         f"dequant_idct_add takes a picture's TUs at once")
    return dequant_inverse_transform_ref(levels, qp, bit_depth, log2_size,
                                         mode)


def _block_index(xs, ys, n):
    """(rows, cols) index tensors of B n x n blocks at (xs, ys)."""
    ar = torch.arange(n, device=xs.device)
    xs, ys = xs.long(), ys.long()
    return (ys[:, None, None] + ar[None, :, None],
            xs[:, None, None] + ar[None, None, :])


def _block_grid_add(plane, xs, ys, res, n, max_v, min_v=0):
    """Add residual (B, n, n) blocks at sample coords (xs, ys) (disjoint)
    and clip to [min_v, max_v], in place; returns the plane."""
    rows, cols = _block_index(xs, ys, n)
    cur = plane[rows, cols].to(torch.int32)
    plane[rows, cols] = (cur + res).clamp(min_v, max_v).to(plane.dtype)
    return plane


def _check_add(coeff_planes, planes, table, bit_depths):
    """Raises on anything the kernel does not take; returns the table's
    rows sorted by size, largest first (the kernel gives each thread block
    one size), and their (comp, log2, mode) columns."""
    coeff_planes, planes = list(coeff_planes), list(planes)
    if len(coeff_planes) != 3 or len(planes) != 3 or len(bit_depths) != 3:
        raise ValueError("three coefficient planes, three planes and three "
                         "bit depths (Y, Cb, Cr) required")
    dev = planes[0].device
    for c, p in zip(coeff_planes, planes):
        if not (isinstance(c, torch.Tensor) and isinstance(p, torch.Tensor)):
            raise TypeError("planes must be torch tensors")
        if c.dtype != torch.int16 or p.dtype != torch.int16:
            raise TypeError(f"int16 planes required, got {c.dtype}, "
                            f"{p.dtype}")
        if c.dim() != 2 or c.shape != p.shape:
            raise ValueError(f"each coefficient plane must be (H, W) like "
                             f"its plane, got {tuple(c.shape)} and "
                             f"{tuple(p.shape)}")
        if c.device != dev or p.device != dev:
            raise ValueError(f"planes on {c.device} and {p.device}, "
                             f"expected {dev}")
        if not (c.is_contiguous() and p.is_contiguous()):
            raise ValueError("contiguous planes required")
        # the kernel moves 4 samples of a row at a time
        if p.shape[1] % 4 or c.data_ptr() % 8 or p.data_ptr() % 8:
            raise ValueError("planes must be 8-byte aligned with widths a "
                             "multiple of 4")
    if any(not 8 <= int(b) <= 16 for b in bit_depths):
        raise ValueError(f"bit depths {tuple(bit_depths)} unsupported")
    if not isinstance(table, np.ndarray) or table.dtype != np.int32:
        raise TypeError(f"the TU table must be an int32 numpy array, got "
                        f"{type(table).__name__} "
                        f"{getattr(table, 'dtype', '')}")
    if table.ndim != 2 or table.shape[1] != 4:
        raise ValueError(f"the TU table must be (T, 4), got {table.shape}")
    comp, log2, mode = tu_fields(table[:, TU_KIND])
    bad = ((table[:, TU_KIND] >> 7 != 0) | (comp > 2)
           | ~np.isin(log2, LOG2_SIZES) | ~np.isin(mode, MODES))
    if bad.any():
        raise ValueError(f"TU table row {int(np.argmax(bad))}: unknown "
                         f"component, size or mode")
    hw = np.array([p.shape for p in planes], np.int64)[np.minimum(comp, 2)]
    n = 1 << log2
    x, y = table[:, TU_X].astype(np.int64), table[:, TU_Y].astype(np.int64)
    out = (x < 0) | (y < 0) | (x + n > hw[:, 1]) | (y + n > hw[:, 0])
    if out.any():
        i = int(np.argmax(out))
        raise ValueError(f"TU table row {i} ({x[i]}, {y[i]}) size {n[i]} "
                         f"lies outside its {tuple(hw[i])} plane")
    if (x % 4).any():
        raise ValueError("TU x must be a multiple of 4")
    # QP with its offset lies in 0..51 + 6 * (bd - 8) (spec 7.4.9.14), so
    # the dequantization's left shift is at most 3 and stays in int32
    qp_max = 51 + 6 * (np.array(bit_depths, np.int64)[np.minimum(comp, 2)]
                       - 8)
    if ((table[:, TU_QP] < 0) | (table[:, TU_QP] > qp_max)).any():
        raise ValueError("TU QPs must lie in 0..51 + 6 * (bit depth - 8)")
    order = np.argsort(-log2, kind="stable")
    return table[order], comp[order], log2[order], mode[order]


def dequant_idct_add_ref(coeff_planes, planes, table, bit_depths,
                         clip=True):
    """Plain torch version: per (component, size, mode) group of the TU
    table, the levels gathered from the coefficient plane, then
    `dequant_inverse_transform_ref` (modes 0 and 1) or the raw levels
    (mode 2), added to the plane with a clip to [0, 2^bd - 1] (clip=False:
    to the int16 range) in place. Returns the planes."""
    table, comp, log2, mode = _check_add(coeff_planes, planes, table,
                                         bit_depths)
    planes = list(planes)
    keys = np.stack([comp, log2, mode], 1)
    for c, lg, md in np.unique(keys, axis=0).tolist():
        sel = np.nonzero((keys == (c, lg, md)).all(1))[0]
        rows = torch.from_numpy(table[sel]).to(planes[c].device)
        n, bd = 1 << lg, int(bit_depths[c])
        ri, ci = _block_index(rows[:, TU_X], rows[:, TU_Y], n)
        levels = coeff_planes[c][ri, ci].to(torch.int32)
        res = levels if md == 2 else dequant_inverse_transform_ref(
            levels, rows[:, TU_QP].contiguous(), bd, lg, md)
        lo, hi = (0, (1 << bd) - 1) if clip else (-32768, 32767)
        planes[c] = _block_grid_add(planes[c], rows[:, TU_X], rows[:, TU_Y],
                                    res, n, hi, lo)
    return planes


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("dequant_idct").dequant_idct_add_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
        _LAUNCH = fn
    return _LAUNCH


def dequant_idct_add(coeff_planes, planes, table, bit_depths, clip=True):
    """Residuals of a picture's coded TUs, added to its predicted planes.

    coeff_planes: the (H, W) int16 level planes of Y, Cb and Cr; planes:
    the (H, W) int16 predicted planes of the same shapes, updated in place
    and returned; table: (T, 4) int32 numpy rows (x, y, qp, kind) as in
    the module's docstring, every TU inside its plane; bit_depths: the
    three components' bit depths. Each TU gets the flat dequantization and
    the inverse DCT (mode 0), the transform-skip shift (1) or its raw
    levels (2), then the add and the clip to [0, 2^bd - 1]; clip=False
    clips to the int16 range instead, so that zero planes take the
    residuals themselves (the kernel's second instance). CPU tensors take
    the plain version; CUDA tensors launch the kernel once for the whole
    table (nothing when it is empty), and a failed build or launch
    raises."""
    global launches
    table, _comp, log2, _mode = _check_add(coeff_planes, planes, table,
                                           bit_depths)
    planes = list(planes)
    dev = planes[0].device
    if dev.type == "cpu":
        return dequant_idct_add_ref(coeff_planes, planes, table, bit_depths,
                                    clip)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not len(table):
        return planes
    # rows of each size, largest first, as the sorted table holds them
    counts = (ctypes.c_int * 4)(*[int((log2 == lg).sum())
                                  for lg in LOG2_SIZES[::-1]])
    rows = torch.from_numpy(table).to(dev)
    # the planes' addresses go to the kernel by value: no stack is copied
    ptrs = (ctypes.c_void_p * 6)(*[p.data_ptr() for p in
                                   list(coeff_planes) + planes])
    hw = (ctypes.c_int * 6)(*[s for p in planes for s in p.shape])
    bds = (ctypes.c_int * 3)(*map(int, bit_depths))
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(ptrs, hw, bds, rows.data_ptr(), counts,
                LEVEL_SCALE.ctypes.data, int(clip), stream)
    if rc != 0:
        raise RuntimeError(f"dequant_idct launch failed: CUDA error {rc}")
    launches += 1
    return planes
