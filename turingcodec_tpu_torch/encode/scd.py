"""Shot-change detection — turing/SCDetection.h parity.

The reference pipeline (SCDetection.h:36-456, driven from a lookahead
preanalysis window by InputQueue::preanalyse, InputQueue.cpp:413-427):

- per frame: 64-bin histogram of (8-bit luma >> 2); dhist[i] = L1 distance
  between consecutive frames' histograms;
- a sliding 10-entry dhist window centred on d[c]: frame c is a cut when
  d[c] is the window maximum AND exceeds left/right mean + K*stddev
  (K=45 hard; K=7 soft, confirmed by a block-variance Gaussian
  likelihood test against threshold 1.7);
- fades: an all-black/all-white frame latches a pending cut placed on the
  first subsequent normal frame;
- cuts at least DELAY=5 frames apart.

Decisions for frame c finalize when frame c+5 arrives, so the encoder
holds a lookahead queue (encoder.py) and IDRs land exactly on the cut —
the InputQueue preanalysis-window behavior. The reference's window stats
quirk (right-side mean/stddev sum 4 entries but divide by 5,
SCDetection.h:349-357) is replicated for behavioral parity; its
likelihood block reads stride by width (the upstream `h*height` indexing
at SCDetection.h:90 is an out-of-bounds stride bug we do not copy).
"""
from __future__ import annotations

import math

import numpy as np

WINDOW = 5
DELAY = 5
TH_HARD = 45.0
TH_SOFT = 7.0
LIKE_THRESHOLD = 1.7


def _likelihood(prev8: np.ndarray, cur8: np.ndarray) -> float:
    """Block-variance Gaussian likelihood (SCDetection.h:62-181): prev
    frame's interior 6x6 block grid vs the current frame's central 4x4;
    each current block takes the minimum likelihood over its 3x3 prev
    neighbourhood; returns the 4x4 average."""
    h, w = prev8.shape
    bh, bw = h >> 3, w >> 3

    def grid_stats(frame, j0, nj, i0, ni):
        avg = np.empty((nj, ni))
        var = np.empty((nj, ni))
        for j in range(nj):
            for i in range(ni):
                blk = frame[(j0 + j) * bh:(j0 + j + 1) * bh,
                            (i0 + i) * bw:(i0 + i + 1) * bw].astype(
                                np.float64)
                avg[j, i] = blk.mean()
                var[j, i] = blk.var()
        return avg, var

    pa, pv = grid_stats(prev8, 1, 6, 1, 6)
    ca, cv = grid_stats(cur8, 2, 4, 2, 4)
    total = 0.0
    for j in range(4):
        for i in range(4):
            best = 1e7
            for s in range(j, j + 3):
                for k in range(i, i + 3):
                    t = (ca[j, i] - pa[s, k]) / 2.0
                    t = t * t
                    tv = (pv[s, k] + cv[j, i]) / 2.0
                    t = (t + tv) * (t + tv)
                    denom = pv[s, k] * cv[j, i]
                    lk = t / denom if denom else 1e7
                    if lk < best:
                        best = lk
            total += best
    return total / 16.0


class ShotChangeDetector:
    """Streaming detector; frame c's decision is final once frame c+5 has
    been pushed (or finish() is called)."""

    def __init__(self, bit_depth: int = 8):
        self.bit_depth = bit_depth
        self.n = 0
        self.flags = {}
        self.dhist = [0]          # d[i]: transition (i-1) -> i
        self.hist_prev = None
        self.frames8 = {}         # retained recent 8-bit lumas
        self.last_sc = 0
        self.next_is_fade = False

    # -- streaming ------------------------------------------------------
    def push(self, luma: np.ndarray) -> None:
        i = self.n
        self.n += 1
        f8 = np.asarray(luma)
        if self.bit_depth > 8:
            f8 = f8 >> (self.bit_depth - 8)
        f8 = f8.astype(np.uint8)
        self.frames8[i] = f8
        hist = np.bincount((f8 >> 2).ravel(), minlength=64)[:64]

        # window decision for c = i - 5 first (reference loop order)
        if i >= 2 * WINDOW + 1:
            self._window_decide(i - WINDOW)

        # fade detection for frame i (causal)
        lsize = f8.size
        blacks = int(hist[:9].sum())
        whites = int(hist[55:].sum())
        if blacks == lsize or whites == lsize:
            self.next_is_fade = True
        elif self.next_is_fade and (i + 1 - self.last_sc) > DELAY:
            self.last_sc = i
            self.flags[i] = True
            self.next_is_fade = False

        if self.hist_prev is not None:
            self.dhist.append(int(np.abs(hist - self.hist_prev).sum()))
        self.hist_prev = hist
        # retain only the frames the likelihood test can still need
        for k in list(self.frames8):
            if k < i - (2 * WINDOW + 2):
                del self.frames8[k]

    def _window_decide(self, c: int) -> None:
        d = self.dhist
        left = d[c - WINDOW:c]
        right = d[c + 1:c + WINDOW]
        window = d[c - WINDOW:c + WINDOW]
        la = sum(left) / float(WINDOW)
        # reference quirk: right-side sums cover WINDOW-1 entries but
        # divide by WINDOW (SCDetection.h:349-357)
        ra = sum(right) / float(WINDOW)
        ls = math.sqrt(sum((e - la) ** 2 for e in left) / float(WINDOW))
        rs = math.sqrt(sum((e - ra) ** 2 for e in right) / float(WINDOW))
        th_max = max(la + TH_HARD * ls, ra + TH_HARD * rs)
        th_min = max(la + TH_SOFT * ls, ra + TH_SOFT * rs)
        if d[c] < max(window):
            return
        if d[c] > th_max and (c - 1 - self.last_sc) > DELAY:
            self.last_sc = c
            self.flags[c] = True
        elif d[c] > th_min and (c - 1 - self.last_sc) > DELAY:
            if c - 1 in self.frames8 and c in self.frames8:
                lk = _likelihood(self.frames8[c - 1], self.frames8[c])
                if lk < LIKE_THRESHOLD:
                    self.last_sc = c
                    self.flags[c] = True

    # -- queries --------------------------------------------------------
    def decided_upto(self) -> int:
        """Frames with index < this value have final decisions."""
        return max(0, self.n - WINDOW)

    def finish(self) -> None:
        """End of stream: remaining frames keep their (causal) flags —
        the reference's trailing sub-window region detects no cuts."""
        self.n += WINDOW  # makes decided_upto() cover everything

    def is_shot_change(self, idx: int) -> bool:
        return bool(self.flags.get(idx, False))
