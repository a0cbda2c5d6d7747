"""Vectorized encoder sweeps (numpy): all-35-mode intra prediction + batched
SATD — the host twins of ops/intra.py / ops/metrics.py used inside the
sequential mode-decision loop (one call replaces 35+35 per CU).
"""
from __future__ import annotations

import functools

import numpy as np

from turingcodec_tpu_torch.ops.intra import _angular_tables
from turingcodec_tpu_torch.ops.metrics import _h_mat


@functools.lru_cache(maxsize=None)
def _stacked_tables(n):
    """Stack _angular_tables(n) across the 33 angular modes.

    Modes 2..17 are horizontal (negative extension from top, main from
    left), 18..34 vertical — contiguous runs, so plain slices suffice."""
    tabs = _angular_tables(n)
    assert [t[0] for t in tabs] == [False] * 16 + [True] * 17
    pos = np.stack([t[1] for t in tabs]).astype(np.int64)   # (33, n, n)
    fact = np.stack([t[2] for t in tabs]).astype(np.int32)
    neg = np.stack([t[3][:n] for t in tabs])                # (33, n)
    base = (np.arange(33, dtype=np.int64) * (3 * n + 2))[:, None, None]
    pos0 = pos + base            # gather indices into ext.reshape(-1)
    return pos0, fact, neg


def intra_all_modes_np(ref_top, ref_left, corner, n, bit_depth=8):
    """(2n+1,) refs -> (35, n, n) predictions (no luma edge filters —
    matches the HM-style SATD ranking; RD refinement uses exact preds)."""
    rt = ref_top.astype(np.int32)
    rl = ref_left.astype(np.int32)
    co = int(corner)
    out = np.empty((35, n, n), np.int32)
    x = np.arange(n)
    log2n = int(n).bit_length() - 1
    # planar
    out[0] = ((n - 1 - x)[None, :] * rl[:n, None]
              + (x + 1)[None, :] * rt[n]
              + (n - 1 - x)[:, None] * rt[None, :n]
              + (x + 1)[:, None] * rl[n] + n) >> (log2n + 1)
    # DC (no edge filter)
    out[1] = (int(rt[:n].sum()) + int(rl[:n].sum()) + n) >> (log2n + 1)
    # all 33 angular modes at once via stacked gather tables
    pos0, fact, neg = _stacked_tables(n)
    ext = np.empty((33, 3 * n + 2), np.int32)
    ext[:16, :n] = np.where(neg[:16] < 0, co, rt[np.maximum(neg[:16], 0)])
    ext[16:, :n] = np.where(neg[16:] < 0, co, rl[np.maximum(neg[16:], 0)])
    ext[:, n] = co
    ext[:16, n + 1:3 * n + 1] = rl[None, :2 * n]
    ext[16:, n + 1:3 * n + 1] = rt[None, :2 * n]
    ext[:16, 3 * n + 1] = rl[2 * n - 1]
    ext[16:, 3 * n + 1] = rt[2 * n - 1]
    flat = ext.reshape(-1)
    g0 = flat[pos0]
    out[2:] = ((32 - fact) * g0 + fact * flat[pos0 + 1] + 16) >> 5
    return out


@functools.lru_cache(maxsize=None)
def _h8():
    return _h_mat(8).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _h4():
    return _h_mat(4).astype(np.int32)


def satd_many(orig, preds, block=8):
    """orig (h, w) vs preds (M, h, w) -> (M,) SATD (same as metrics.satd_np)."""
    m, hh, ww = preds.shape
    hb = _h8() if block == 8 else _h4()
    d = orig[None].astype(np.int32) - preds.astype(np.int32)
    bh, bw = hh // block, ww // block
    d = np.ascontiguousarray(
        d.reshape(m, bh, block, bw, block).transpose(0, 1, 3, 2, 4))
    t = hb @ d @ hb   # |t| <= block^2 * 1023 for 10-bit: fits int32
    s = np.abs(t).sum(axis=(3, 4))
    if block == 8:
        s = (s + 2) >> 2
    else:
        s = (s + 1) >> 1
    return s.sum(axis=(1, 2))


def sad_many(orig, ref_plane, xs, ys, bw, bh):
    """SAD of orig (bh, bw) against candidates at (xs[i], ys[i])."""
    h, w = ref_plane.shape
    ry = np.clip(ys[:, None] + np.arange(bh)[None, :], 0, h - 1)
    rx = np.clip(xs[:, None] + np.arange(bw)[None, :], 0, w - 1)
    blocks = ref_plane[ry[:, :, None], rx[:, None, :]].astype(np.int32)
    return np.abs(orig[None] - blocks).sum(axis=(1, 2))
