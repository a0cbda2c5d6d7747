"""Angular intra gather tables the host encoder needs (numpy). The
batched 35-mode device prediction of `turingcodec_tpu.ops.intra` is not
ported yet.

Parity reference: decode/reconstruct.intra_predict, spec 8.4.4.2.6.
"""
from __future__ import annotations

import functools

import numpy as np

from turingcodec_tpu_torch.hevc.tables import INTRA_PRED_ANGLE, INTRA_INV_ANGLE


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
