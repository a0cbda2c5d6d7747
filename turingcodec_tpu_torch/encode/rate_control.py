"""Rate control: λ-domain R-λ model (CBR), the analogue of
turing/RateControl.h SequenceController/PictureController (759/494).

Model: bits-per-pixel -> λ via λ = α·bpp^β with per-temporal-level (α, β)
adapted after each coded picture; QP from λ via the HM relation
QP = 4.2005·ln λ + 13.7122, clipped for smoothness.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


_LEVEL_WEIGHTS = {  # relative bit share per hierarchy level (gop 8-ish)
    0: 14.0, 1: 5.0, 2: 2.5, 3: 1.0,
}


@dataclass
class _Model:
    alpha: float = 3.2003
    beta: float = -1.367


def intra_complexity(y_plane, bit_depth: int = 8) -> int:
    """EstimateIntraComplexity::preAnalysis (EstimateIntraComplexity.h:27):
    per-8x8 source-pixel Hadamard 'SATD' with the DC term excluded,
    (sad+2)>>2 per block (>>2 more at 10 bit), summed over the picture.
    Feeds the intra picture bit allocation
    (SequenceController::pictureRateAllocationIntra, RateControl.cpp:905)."""
    import numpy as np
    h, w = y_plane.shape
    hb, wb = h >> 3, w >> 3
    if hb == 0 or wb == 0:
        return 0
    blocks = y_plane[:hb * 8, :wb * 8].astype(np.int64).reshape(
        hb, 8, wb, 8).transpose(0, 2, 1, 3)
    hmat = np.array([[1, 1], [1, -1]], np.int64)
    for _ in range(2):
        hmat = np.kron(hmat, np.array([[1, 1], [1, -1]], np.int64))
    t = hmat @ blocks @ hmat
    sad = np.abs(t).sum(axis=(2, 3)) - np.abs(t[:, :, 0, 0])
    sad = (sad + 2) >> 2
    if bit_depth > 8:
        sad >>= 2
    return int(sad.sum())


def intra_complexity_map(y_plane, ctb_log2: int, bit_depth: int = 8):
    """Per-CTB EstimateIntraComplexity sums (for the intra CTB-level bit
    allocation, RateControl.cpp pictureRateAllocationIntra/CTB path)."""
    import numpy as np
    h, w = y_plane.shape
    hb, wb = h >> 3, w >> 3
    out_hc = -(-h // (1 << ctb_log2))
    out_wc = -(-w // (1 << ctb_log2))
    out = np.zeros((out_hc, out_wc), np.int64)
    if hb == 0 or wb == 0:
        return out + 1
    blocks = y_plane[:hb * 8, :wb * 8].astype(np.int64).reshape(
        hb, 8, wb, 8).transpose(0, 2, 1, 3)
    hmat = np.array([[1, 1], [1, -1]], np.int64)
    for _ in range(2):
        hmat = np.kron(hmat, np.array([[1, 1], [1, -1]], np.int64))
    t = hmat @ blocks @ hmat
    sad = np.abs(t).sum(axis=(2, 3)) - np.abs(t[:, :, 0, 0])
    sad = (sad + 2) >> 2
    if bit_depth > 8:
        sad >>= 2
    k = (1 << ctb_log2) >> 3
    for by in range(hb):
        for bx in range(wb):
            out[by // k, bx // k] += int(sad[by, bx])
    return np.maximum(out, 1)


class CpbInfo:
    """HRD coded-picture-buffer tracker (turing/RateControl.h:147-188):
    per-picture fill at bitrate/framerate, drain by coded bits; allocation
    adjustment steers away from over/underflow of the *signalled* CPB."""

    def __init__(self, cpb_size_bits: float, target_bps: float,
                 frame_rate: float, initial_fullness: float = 0.9):
        self.size = float(cpb_size_bits)
        self.status = self.size * initial_fullness
        self.rate_per_pic = target_bps / frame_rate
        self.underflows = 0
        self.overflows = 0

    def adjust_allocation(self, bits: float) -> float:
        """Pre-picture target-bits correction (adjustAllocatedBits)."""
        lo, hi = 0.3 * bits, 3.0 * bits
        est = self.status + self.rate_per_pic
        over = 0.9 * self.size
        under = 0.1 * self.size
        if est - bits > over:       # spending too little -> CPB overflow
            bits = est - over
        elif est - bits < under:    # spending too much -> CPB underflow
            bits = est - under
        return min(max(bits, lo), hi)

    def update(self, coded_bits: float) -> None:
        """Post-picture buffer arithmetic (updateCpbStatus + bounds)."""
        self.status += self.rate_per_pic - coded_bits
        if self.status < 0.0:
            self.underflows += 1
            self.status = 0.0
        if self.status > self.size:
            self.overflows += 1
            self.status = self.size


class CtbRateController:
    """Per-CTU bit allocation and lambda/QP adaptation inside one picture
    (turing/RateControl.h:412 CtbController + RateControl.cpp:257-483,
    driven from the search like Write.h:745-765). R-lambda models per CTB
    persist across pictures of the same hierarchy level via `store`."""

    CLIP_LO, CLIP_HI = 2, 46  # reference CTB QP bounds

    def __init__(self, wc: int, hc: int, ctb: int, width: int, height: int,
                 target_bits: float, pic_qp: int, pic_lambda: float,
                 is_intra: bool, store: dict, level: int,
                 intra_costs=None):
        import numpy as np
        self.wc, self.hc = wc, hc
        self.pic_qp = pic_qp
        self.pic_lambda = pic_lambda
        self.is_intra = is_intra
        self.store = store
        self.level = level
        n = wc * hc
        self.pixels = np.zeros(n)
        for ry in range(hc):
            for rx in range(wc):
                pw = min(ctb, width - rx * ctb)
                ph = min(ctb, height - ry * ctb)
                self.pixels[ry * wc + rx] = pw * ph
        # per-CTB estimated share of the picture budget
        if is_intra and intra_costs is not None:
            wgt = np.asarray(intra_costs, np.float64).reshape(-1)
            self.costs = wgt
        else:
            wgt = self.pixels.copy()
            self.costs = None
        self.est = target_bits * wgt / wgt.sum()
        self.cum_target = 0.0
        self.cum_spent = 0.0
        self.last_qp = None
        self.qp_used = np.zeros(n, np.int32)

    def _model(self, idx: int):
        key = (self.level, idx)
        if key not in self.store:
            self.store[key] = _Model() if not self.is_intra else \
                _Model(alpha=6.7542, beta=-1.7860)
        return self.store[key]

    def pre_ctu(self, idx: int) -> int:
        """Target bits -> lambda -> QP for the CTB about to be searched
        (computeCtbTargetBits + estimateCtbLambdaAndQp)."""
        import math
        px = self.pixels[idx]
        max_bits = int(8 * px * 3) >> 1
        target = self.est[idx] + (self.cum_target - self.cum_spent)
        target = min(max(target, 1.0), float(max_bits))
        bpp = target / px
        m = self._model(idx)
        if self.is_intra and self.costs is not None:
            cost_px = (self.costs[idx] / px) ** 1.2517  # BETA_INTRA_MAD
            lam = (m.alpha / 256.0) * ((cost_px / bpp) ** m.beta)
        else:
            lam = m.alpha * (bpp ** m.beta)
        if self.pic_lambda > 0:
            lam = min(max(lam, self.pic_lambda * 0.25),
                      self.pic_lambda * 4.0)
        lam = min(max(lam, 0.1), 10000.0)
        qp = int(4.2005 * math.log(lam) + 13.7122 + 0.5)
        r = 4 if self.is_intra else 3
        lo, hi = self.pic_qp - r, self.pic_qp + r
        if self.last_qp is not None:
            lo = max(self.last_qp - 2, lo)
            hi = min(self.last_qp + 2, hi)
        qp = min(max(qp, lo), hi)
        qp = min(max(qp, self.CLIP_LO), self.CLIP_HI)
        self._cur = (idx, target, bpp, lam, qp)
        self.qp_used[idx] = qp
        return qp

    def post_ctu(self, bits: float) -> None:
        """Model adaptation from the CTB's actual bits (the search's exact
        committed rate) — updateCtbModelParameters analogue."""
        import math
        idx, target, bpp, lam, qp = self._cur
        self.cum_target += self.est[idx]
        self.cum_spent += bits
        self.last_qp = qp
        m = self._model(idx)
        bpp_real = max(bits / self.pixels[idx], 1e-6)
        if self.is_intra and self.costs is not None:
            diff = m.beta * (math.log(max(bits, 1.0))
                             - math.log(max(target, 1.0)))
            diff = min(max(0.25 * diff, -0.125), 0.125)
            m.alpha *= math.exp(diff)
            lnc = math.log((self.costs[idx] / self.pixels[idx]) ** 1.2517)
            if abs(lnc) > 1e-6:
                m.beta += diff / lnc
        else:
            ln_err = math.log(lam) - math.log(
                max(m.alpha * (bpp_real ** m.beta), 1e-9))
            m.alpha *= math.exp(min(max(0.10 * ln_err, -0.5), 0.5))
            m.alpha = min(max(m.alpha, 0.05), 500.0)
            m.beta += min(max(0.05 * ln_err * math.log(bpp_real), -0.2),
                          0.2)
            m.beta = min(max(m.beta, -3.0), -0.1)


class SequenceRateController:
    def __init__(self, target_bps: float, frame_rate: float,
                 width: int, height: int, base_qp: int = 32,
                 level_mix=None):
        self.target_bpp = target_bps / (frame_rate * width * height)
        self.pixels = width * height
        self.models = {lvl: _Model() for lvl in range(5)}
        self.intra_model = _Model(alpha=6.7542, beta=-1.7860)
        self.buffer_debt = 0.0   # bits over/under budget so far
        self.spent_bits = 0.0    # total coded bits so far
        self.base_qp = base_qp
        self.last_qp = base_qp
        self.frames_coded = 0
        # normalize weights over the actual temporal-level mix of the GOP
        mix = level_mix or {0: 1}
        total = sum(mix.values())
        self.weight_avg = sum(
            _LEVEL_WEIGHTS.get(l, 1.0) * c for l, c in mix.items()) / total

    # ------------------------------------------------------------------
    def pre_picture(self, is_intra: bool, temporal_id: int,
                    intra_cost: int = 0) -> tuple:
        """Returns (qp, lambda, target_bits) for the next picture.

        intra_cost: the EstimateIntraComplexity SATD sum — when given for
        an intra picture, its allocation follows the reference's
        complexity-scaled formula (pictureRateAllocationIntra,
        RateControl.cpp:905-935: bits = a*(cost*4/avg)^0.5582*avg)
        instead of the fixed 4x weight."""
        w = 4.0 if is_intra else _LEVEL_WEIGHTS.get(temporal_id, 1.0)
        # sliding-window remaining-budget allocation: the budget through
        # the end of a one-second window, spread by hierarchy weight —
        # keeps the long-run average within a fraction of a percent
        # (SequenceController::pictureRateAllocation smoothing analogue)
        window = 24.0
        budget = self.target_bpp * self.pixels \
            * (self.frames_coded + window) - self.spent_bits
        base_bpp = budget / (window * self.pixels)
        target_bpp = base_bpp * w / self.weight_avg
        if is_intra and intra_cost > 0:
            avg_bits = max(base_bpp * self.pixels, 200.0)
            a = 0.25 if avg_bits * 40 < self.pixels else 0.30
            bits = a * ((intra_cost * 4.0 / avg_bits) ** 0.5582) * avg_bits
            target_bpp = min(bits / self.pixels, max(base_bpp * 8.0, 1e-5))
        target_bpp = max(target_bpp, 0.1 * self.target_bpp)
        model = self.intra_model if is_intra else self.models[min(temporal_id, 4)]
        lam = model.alpha * (target_bpp ** model.beta)
        lam = min(max(lam, 0.1), 10000.0)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        qp = min(max(qp, self.last_qp - 3), self.last_qp + 3)
        qp = min(max(qp, 1), 51)
        self._cur = (model, target_bpp, lam, qp)
        return qp, lam, target_bpp * self.pixels

    def post_picture(self, actual_bits: int):
        model, target_bpp, lam_used, qp = self._cur
        bpp_real = max(actual_bits / self.pixels, 1e-6)
        # adapt alpha/beta towards observed (bpp, lambda)
        ln_err = math.log(lam_used) - math.log(
            max(model.alpha * (bpp_real ** model.beta), 1e-9))
        model.alpha *= math.exp(min(max(0.10 * ln_err, -0.5), 0.5))
        model.alpha = min(max(model.alpha, 0.05), 500.0)
        model.beta += min(max(0.05 * ln_err * math.log(bpp_real), -0.2), 0.2)
        model.beta = min(max(model.beta, -3.0), -0.1)
        self.buffer_debt += actual_bits - target_bpp * self.pixels
        self.spent_bits += actual_bits
        self.last_qp = qp
        self.frames_coded += 1
