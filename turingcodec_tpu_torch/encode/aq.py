"""Adaptive quantization: TM5 activity-based per-CTB dQP
(turing/AdaptiveQuantisation.h analogue at CTB granularity).

The reference builds an activity pyramid (layers of maxCuSize>>d units,
AdaptiveQuantisation.h:120-128) and queries per-CU offsets during the
search (Search.hpp:1145); our encoder signals dQP at CTB quantization
groups, so the depth-0 layer semantics apply per CTB:

  activity(u)        = 1 + min variance over u's four quadrant blocks
                       (TM5's minvar; AdaptiveQuantisation.h:230-241)
  norm(u)            = (s*act + avg) / (act + s*avg),  s = 2^(range/6)
  qp_offset(u)       = floor(log2(norm) * 6 + 0.49999)
                       (AdaptiveQuantisation.h:138-154)

scaled by the configured strength (strength 1.0 = the reference's
formula). Deviation noted: the reference's quadrant-0/1 sum-of-squares
accumulators are buggy (assignment instead of accumulation, missing
square — AdaptiveQuantisation.h:186-200); this implementation computes
all four quadrant variances correctly.
"""
from __future__ import annotations

import numpy as np


def _aq_layer(pad: np.ndarray, hn: int, wn: int, unit: int,
              strength: float, max_range: int) -> np.ndarray:
    """One pyramid layer's dQP map over (hn, wn) units of `unit` samples
    (the reference's AdaptiveQuantisationLayer at maxCuSize>>d;
    per-layer average activity, AdaptiveQuantisation.h:162-247)."""
    q = unit // 2
    b = pad.reshape(hn * 2, q, wn * 2, q).transpose(0, 2, 1, 3)
    v = b.var(axis=(2, 3))
    minvar = v.reshape(hn, 2, wn, 2).transpose(0, 2, 1, 3).min(axis=(2, 3))
    act = 1.0 + minvar
    avg = float(act.mean())
    s = 2.0 ** (max_range / 6.0)
    norm = (s * act + avg) / (act + s * avg)
    dqp = np.floor(strength * (np.log2(norm) * 6.0) + 0.49999)
    return np.clip(dqp, -max_range, max_range).astype(np.int32)


def compute_aq_map(luma: np.ndarray, ctb_log2: int, strength: float,
                   max_range: int = 6) -> np.ndarray:
    return compute_aq_layers(luma, ctb_log2, strength, 0, max_range)[0]


def compute_aq_layers(luma: np.ndarray, ctb_log2: int, strength: float,
                      depth: int, max_range: int = 6) -> list:
    """Activity pyramid for per-CU AQ: layer d holds dQP per
    (ctb>>d)-sized unit; the search queries layer min(cu_depth, depth)
    at each CU (reference Search.hpp:1145 getAqOffset). depth 0 == the
    per-CTB map."""
    h, w = luma.shape
    ctb = 1 << ctb_log2
    hc = -(-h // ctb)
    wc = -(-w // ctb)
    pad = np.pad(luma.astype(np.float64),
                 ((0, hc * ctb - h), (0, wc * ctb - w)), mode="edge")
    out = []
    for d in range(depth + 1):
        unit = ctb >> d
        out.append(_aq_layer(pad, hc << d, wc << d, unit, strength,
                             max_range))
    return out
