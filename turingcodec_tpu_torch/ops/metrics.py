"""Hadamard SATD helpers the host encoder needs (numpy). The batched
device metrics of `turingcodec_tpu.ops.metrics` are not ported yet.

Parity reference: havoc/hadamard.cpp.
"""
from __future__ import annotations

import functools

import numpy as np


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
