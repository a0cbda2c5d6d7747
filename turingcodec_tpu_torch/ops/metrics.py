"""Batched distortion metrics: SAD, SSD, Hadamard SATD (torch), and the
numpy SATD helpers the host encoder needs.

Twins of `turingcodec_tpu/ops/metrics.py` (havoc/sad.cpp, ssd.cpp,
hadamard.cpp): shapes are (..., H, W) blocks with any leading dims. They
are elementwise work and add/sub butterflies, which torch computes exactly
in int32 on any device, so they are torch code and no kernel.

Parity reference: havoc/hadamard.cpp.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def sad_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., H, W) int -> (...,) int32 sum of absolute differences."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return d.abs().sum((-2, -1), dtype=torch.int32)


def ssd_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (...,) int64 sum of squared differences.

    The JAX package sums int32 squares in uint32 (exact up to 64x64 10-bit
    blocks); torch's uint32 has no CUDA reduction, so the sum is int64:
    the same values wherever the uint32 sum does not wrap."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return (d * d).sum((-2, -1), dtype=torch.int64)


def _wht_last(x: torch.Tensor) -> torch.Tensor:
    """Natural-order (Sylvester) Walsh-Hadamard transform along the last
    dim by add/sub butterflies: x @ H, exact in integers (torch has no
    integer matmul on CUDA)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    h = 1
    while h < n:
        y = x.reshape(lead + (n // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack((a + b, a - b), -2).reshape(lead + (n,))
        h *= 2
    return x


def satd_batch(a: torch.Tensor, b: torch.Tensor,
               block: int = 8) -> torch.Tensor:
    """Hadamard SATD over (..., H, W) with H and W multiples of block (a
    power of two) -> (...,) int32.

    The HM/havoc convention: per 8x8 block (sum |H d H| + 2) >> 2, per 4x4
    (sum + 1) >> 1, summed over the partition. H d H is two butterfly
    passes; the transpose between them leaves the sum of absolute values
    unchanged."""
    if block < 1 or block & (block - 1):
        raise ValueError(f"block {block} is not a power of two")
    h, w = a.shape[-2:]
    if h % block or w % block:
        raise ValueError(f"({h}, {w}) blocks are not multiples of {block}")
    d = a.to(torch.int32) - b.to(torch.int32)
    lead = d.shape[:-2]
    d = d.reshape(lead + (h // block, block, w // block, block))
    d = d.movedim(-2, -3)  # (..., bh, bw, block, block)
    t = _wht_last(_wht_last(d).transpose(-1, -2))
    s = t.abs().sum((-2, -1), dtype=torch.int32)
    if block == 8:
        s = (s + 2) >> 2
    elif block == 4:
        s = (s + 1) >> 1
    return s.sum((-2, -1), dtype=torch.int32)


def _hadamard_matrix(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@functools.lru_cache(maxsize=None)
def _h_mat(n):
    return _hadamard_matrix(n)


def satd_np(a: np.ndarray, b: np.ndarray, block: int = 8) -> int:
    """numpy oracle."""
    h, w = a.shape
    m = _h_mat(block).astype(np.int64)
    total = 0
    for y in range(0, h, block):
        for x in range(0, w, block):
            d = (a[y:y + block, x:x + block].astype(np.int64)
                 - b[y:y + block, x:x + block])
            t = m @ d @ m
            s = int(np.abs(t).sum())
            if block == 8:
                s = (s + 2) >> 2
            elif block == 4:
                s = (s + 1) >> 1
            total += s
    return total
