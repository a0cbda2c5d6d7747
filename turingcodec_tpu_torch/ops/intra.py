"""Batched intra prediction: all 35 modes for a batch of blocks in one
call (the encoder's SATD sweep, turing/Search.hpp:92-145), and the angular
gather tables the host encoder needs (numpy).

`intra_predict_all_modes` is the twin of `turingcodec_tpu/ops/intra.py::
intra_predict_all_modes`: gathers through static index tables and integer
arithmetic, which torch computes exactly in int32 on any device, so it is
torch code and no kernel.

Parity reference: decode/reconstruct.intra_predict, spec 8.4.4.2.6.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from turingcodec_tpu_torch.hevc.tables import INTRA_PRED_ANGLE, INTRA_INV_ANGLE
from turingcodec_tpu_torch.ops.kernel_build import table


@functools.lru_cache(maxsize=None)
def _angular_tables(n: int):
    """Static gather tables for all 33 angular modes of size n.

    For each mode m (2..34): prediction reads main_ref[pos] and
    main_ref[pos+1] with weights (32-f, f). main_ref is laid out as
    [-n..2n+1] from either top or left depending on the mode; we build
    indices into a unified array: ext[k] for k in 0..(3n+1) where
    ext = [projected negatives..., corner, main row/col samples...].

    Returns per-mode: (is_vertical, idx (n, n), fact (n, n), neg_src_idx
    (n,) source indices used to build the negative extension).
    """
    tabs = []
    for mode in range(2, 35):
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18
        d = np.arange(1, n + 1)
        i_idx = (d * angle) >> 5
        i_fact = (d * angle) & 31
        xs = np.arange(n)
        # position into main[] with offset n (main[n] == corner)
        pos = n + 1 + (i_idx[:, None] if vertical else i_idx[None, :]) \
            + (xs[None, :] if vertical else xs[:, None])
        fact = (i_fact[:, None] if vertical else i_fact[None, :]) \
            * np.ones((n, n), np.int32)
        # negative extension sources (into the OTHER reference array)
        neg_src = np.zeros(n + 1, np.int32)  # for main[0..n-1] = ref[-n..-1]
        if angle < 0:
            inv = int(INTRA_INV_ANGLE[mode - 11])
            for x in range(-1, ((n * angle) >> 5) - 1, -1):
                idx = ((x * inv + 128) >> 8) - 1
                neg_src[n + x] = min(max(idx, -1), 2 * n - 1)
        tabs.append((vertical, pos.astype(np.int32), fact.astype(np.int32),
                     neg_src))
    return tabs


def intra_predict_all_modes(ref_top: torch.Tensor, ref_left: torch.Tensor,
                            corner: torch.Tensor, n: int,
                            bit_depth: int = 8) -> torch.Tensor:
    """(B, 2n+1) top and left references + (B,) corner -> (B, 35, n, n)
    int32 predictions of every mode from the unfiltered references, for n
    in 4..32. The luma edge filters (DC/H/V) are not applied: the
    encoder's SATD sweep ranks on unfiltered-edge predictions, as HM and
    turing do."""
    b = ref_top.shape[0]
    dev = ref_top.device
    max_val = (1 << bit_depth) - 1
    rt = ref_top.to(torch.int32)
    rl = ref_left.to(torch.int32)
    co = corner.to(torch.int32)
    x = torch.arange(n, device=dev, dtype=torch.int32)
    log2n = int(n).bit_length() - 1
    outs = []

    # planar
    planar = ((n - 1 - x)[None, None, :] * rl[:, :n, None]
              + (x + 1)[None, None, :] * rt[:, n, None, None]
              + (n - 1 - x)[None, :, None] * rt[:, None, :n]
              + (x + 1)[None, :, None] * rl[:, n, None, None]
              + n) >> (log2n + 1)
    outs.append(planar)

    # DC (no edge filter in the sweep)
    dc = (rt[:, :n].sum(1, dtype=torch.int32)
          + rl[:, :n].sum(1, dtype=torch.int32) + n) >> (log2n + 1)
    outs.append(dc[:, None, None].expand(b, n, n))

    # angular: per mode, the extended main reference, then two gathers
    for vertical, pos, fact, neg_src in _angular_tables(n):
        main = rt if vertical else rl
        other = rl if vertical else rt
        neg = table(neg_src, dev)[:n]
        ext_neg = torch.where(neg[None, :] < 0, co[:, None],
                              other[:, neg.clamp(min=0).long()])
        ext = torch.cat([ext_neg, co[:, None], main[:, :2 * n],
                         main[:, 2 * n - 1:2 * n]], 1)
        p = table(pos, dev).long().reshape(-1)
        g0 = ext[:, p].reshape(b, n, n)
        g1 = ext[:, p + 1].reshape(b, n, n)
        f = table(fact, dev)[None]
        outs.append(((32 - f) * g0 + f * g1 + 16) >> 5)
    return torch.stack(outs, 1).clamp(0, max_val)


def intra_predict_all_modes_np(ref_top, ref_left, corner, n, bit_depth=8):
    """numpy oracle built on the scalar decoder op."""
    from turingcodec_tpu_torch.decode.reconstruct import intra_predict
    b = ref_top.shape[0]
    out = np.zeros((b, 35, n, n), np.int32)
    for i in range(b):
        for mode in range(35):
            out[i, mode] = intra_predict(
                mode, ref_top[i], ref_left[i], int(corner[i]), n, 1,
                bit_depth)  # c_idx 1 => no luma edge filters
    return out
