"""HEVC transforms: the forward transform the host encoder needs (numpy),
and the decoder's batched inverse transform as torch code with its CUDA
kernel.

`dequant_inverse_transform` is the decoder's residual stage for one
(component, size, mode) bucket of TUs: dequantization (ops/quant.py) and
the two-stage inverse DCT, or the transform-skip shift. CUDA tensors launch
the hand-written kernel `csrc/dequant_idct.cu`, which replaces the int32
einsums of `turingcodec_tpu/ops/transform.py::inverse_transform_batch`
(torch has no integer matmul on CUDA, and float32 is not exact here);
CPU tensors take the plain torch version, which the kernel is held against
on the card.

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

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_LAUNCH = None


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
    if log2_size not in (2, 3, 4, 5) or mode not in (0, 1):
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


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("dequant_idct").dequant_idct_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        _LAUNCH = fn
    return _LAUNCH


def dequant_inverse_transform(levels: torch.Tensor, qp: torch.Tensor,
                              bit_depth: int, log2_size: int,
                              mode: int) -> torch.Tensor:
    """Residuals of B TUs of one size: (B, N, N) int32 levels with N =
    1 << log2_size and (B,) int32 QP (offset for the bit depth) ->
    (B, N, N) int32. mode 0: flat dequantization, then the two-stage
    inverse DCT; mode 1: dequantization, then the transform-skip shift.
    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a failed build or launch raises."""
    global launches
    b = _check(levels, qp, log2_size, mode)
    if levels.device.type == "cpu":
        return dequant_inverse_transform_ref(levels, qp, bit_depth,
                                             log2_size, mode)
    if levels.device.type != "cuda":
        raise ValueError(f"unsupported device {levels.device}")
    n = 1 << log2_size
    out = torch.empty((b, n, n), dtype=torch.int32, device=levels.device)
    if b == 0:
        return out
    mat = kernel_build.table(_matrix(n, False), levels.device)
    ls = kernel_build.table(LEVEL_SCALE, levels.device)
    fn = _launcher()
    stream = torch.cuda.current_stream(levels.device).cuda_stream
    with torch.cuda.device(levels.device):
        rc = fn(levels.data_ptr(), qp.data_ptr(), mat.data_ptr(),
                ls.data_ptr(), out.data_ptr(), b, log2_size, bit_depth,
                mode, stream)
    if rc != 0:
        raise RuntimeError(f"dequant_idct launch failed: CUDA error {rc}")
    launches += 1
    return out
