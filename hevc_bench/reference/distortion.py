"""Plain numpy yardstick of the coded pictures' distortion, written for
the benchmark; it imports nothing of the port.

- luma_sse: the squared error of a reconstruction against its source;
- anchor_sse: the squared error that a plain transform coder leaves at a
  QP's quantiser step, on the same source: 8x8 orthonormal DCT-II blocks,
  a uniform quantiser of step 2^((QP - 4) / 6) (H.265's step at QP, for a
  transform of unit gain; times 2^(bit depth - 8)) rounding magnitudes up
  from 2/3 of a step (HM's intra rounding offset, 1/3), no prediction.

The anchor follows the content: flat and textured pictures, still and
moving ones, each get the error that quantising them at that step leaves.
"""
from __future__ import annotations

import numpy as np

N = 8


def _dct() -> np.ndarray:
    k = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * N)) * np.sqrt(2.0 / N)
    m[0] /= np.sqrt(2.0)
    return m


_M = _dct()


def luma_sse(recon, source) -> float:
    d = np.asarray(recon, np.int64) - np.asarray(source, np.int64)
    return float((d * d).sum())


def anchor_sse(source, qp: int, bit_depth: int = 8) -> float:
    """The anchor's squared error over the source's whole 8x8 blocks,
    scaled to the whole picture's samples."""
    y = np.asarray(source, np.float64)
    h, w = y.shape[0] - y.shape[0] % N, y.shape[1] - y.shape[1] % N
    x = y[:h, :w].reshape(h // N, N, w // N, N).transpose(0, 2, 1, 3)
    c = _M @ x @ _M.T
    step = 2.0 ** ((qp - 4) / 6.0) * 2.0 ** (bit_depth - 8)
    q = np.sign(c) * np.floor(np.abs(c) / step + 1.0 / 3.0)
    r = _M.T @ (q * step) @ _M
    return float(((r - x) ** 2).sum()) * (y.size / (h * w))
