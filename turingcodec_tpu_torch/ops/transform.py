"""Forward transform helpers the host encoder needs (numpy, integer
arithmetic). The batched device transforms of `turingcodec_tpu.ops.transform`
are not ported yet.

Parity reference: havoc/transform.cpp (all sizes, fwd+inv), spec 8.6.4.
"""
from __future__ import annotations

import functools

import numpy as np

from turingcodec_tpu_torch.hevc.tables import DST4, dct2_matrix


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
