"""CABAC rate estimation: fractional-bit costs per (context state, bin)
without producing bits. Parity reference: turing/EstimateRate.h:33-96,
turing/Cost.h (fixed-point fractional bits).

The RateEstimator mirrors the CabacEncoder's bin API, so the same syntax-
writing code can either emit bits or accumulate their exact entropy cost —
and it applies the same context transitions, so a search-side context pool
tracks the real writer state exactly (the Write.h:820-826 checkRate
invariant becomes testable).
"""
from __future__ import annotations

import numpy as np

from .tables import NEXT_STATE_LPS, NEXT_STATE_MPS

_FRAC = 256  # fixed-point units per bit

# LPS probability model of the HM/spec state machine:
# p_lps(pStateIdx) = 0.5 * alpha^pStateIdx, alpha = (0.01875 / 0.5)^(1/63)
_alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
_p_lps = 0.5 * _alpha ** np.arange(64)
_bits_lps = -np.log2(_p_lps)
_bits_mps = -np.log2(1.0 - _p_lps)

# BITS[state, bin] in 1/256 bit units; state packed 2*pStateIdx + valMps
BITS = np.zeros((128, 2), np.int32)
for _s in range(128):
    _p, _m = _s >> 1, _s & 1
    BITS[_s, _m] = int(round(_bits_mps[_p] * _FRAC))
    BITS[_s, 1 - _m] = int(round(_bits_lps[_p] * _FRAC))

_NEXT = [[int(NEXT_STATE_LPS[s]), int(NEXT_STATE_MPS[s])] for s in range(128)]
_BITS_L = [[int(BITS[s, 0]), int(BITS[s, 1])] for s in range(128)]


class RateEstimator:
    """Accumulates fractional bits; same API surface as CabacEncoder."""

    __slots__ = ("ctx", "frac_bits", "bin_count")

    def __init__(self, ctx):
        self.ctx = ctx
        self.frac_bits = 0
        self.bin_count = 0

    @property
    def bits(self) -> float:
        return self.frac_bits / _FRAC

    def encode_decision(self, ctx_idx: int, bin_val: int):
        states = self.ctx.states
        s = states[ctx_idx]
        self.frac_bits += _BITS_L[s][bin_val]
        states[ctx_idx] = _NEXT[s][1 if bin_val == (s & 1) else 0]
        self.bin_count += 1

    def encode_bypass(self, bin_val: int):
        self.frac_bits += _FRAC
        self.bin_count += 1

    def encode_bypass_bits(self, value: int, n: int):
        self.frac_bits += n * _FRAC
        self.bin_count += n

    def encode_terminate(self, bin_val: int):
        self.frac_bits += 2 if not bin_val else _FRAC

    def encode_egk_bypass(self, value: int, k: int):
        n = 1  # terminating 0
        while value >= (1 << k):
            value -= 1 << k
            k += 1
            n += 1  # prefix 1
        n += k      # suffix bits
        self.frac_bits += n * _FRAC
        self.bin_count += n
