"""All-intra mode decision: recursive CU split RDO with SATD candidate
ranking + exact-CABAC-rate refinement.

The analogue of Search<coding_quadtree>/searchIntraCu (turing/Search.hpp:374,
709) recast plan-first: decisions are committed into PicturePlan tensors and
a working reconstruction; the final picture is re-reconstructed from the plan
by the decoder's own pipeline, guaranteeing encoder-recon == decoder-recon
(the reference asserts the same invariant, signature.cpp:171-177).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from turingcodec_tpu_torch.cabac.engine import CabacEncoder, ContextPool, ctx_index
from turingcodec_tpu_torch.bitstream.writer import BitWriter
from turingcodec_tpu_torch.hevc import types as T
from turingcodec_tpu_torch.hevc.geometry import PictureGeometry
from turingcodec_tpu_torch.hevc.params import Pps, SliceSegmentHeader, Sps
from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
from turingcodec_tpu_torch.decode.plan import PicturePlan
from turingcodec_tpu_torch.decode.reconstruct import (
    ReferenceSampleBuilder,
    dequant_block,
    filter_reference_samples,
    intra_predict,
    inverse_transform,
)
from turingcodec_tpu_torch.ops.transform import forward_transform_np
from turingcodec_tpu_torch.hevc.tables import QUANT_SCALES
from turingcodec_tpu_torch.utils.profiler import TRACE


def quantize_np(coeffs: np.ndarray, qp: int, bit_depth: int, log2_size: int,
                intra: bool) -> np.ndarray:
    """HM-style RDO-free quantization with 1/3 (intra) rounding."""
    t_shift = 15 - bit_depth - log2_size
    q_shift = 14 + qp // 6 + t_shift
    f = int(QUANT_SCALES[qp % 6])
    rnd = (1 << q_shift) // (3 if intra else 6)
    a = np.abs(coeffs.astype(np.int64))
    level = (a * f + rnd) >> q_shift
    level = np.clip(level, 0, 32767)
    return np.where(coeffs < 0, -level, level).astype(np.int32)


def apply_sdh(levels: np.ndarray, coeffs: np.ndarray, qp: int,
              bit_depth: int, log2: int, scan_idx: int) -> np.ndarray:
    """Encoder side of sign data hiding (turing/Rdoq.cpp:889 analogue).

    For each 4x4 sub-block whose significant span exceeds 3 scan
    positions, the sign of the scan-first coefficient is not written and
    the decoder infers it from the parity of the sub-block's absolute-level
    sum (spec 9.3.4.3 res semantics; our parser in ctu_parse). Enforce that
    parity by a minimum-distortion +/-1 adjustment that provably preserves
    the first/last significant positions (so the hidden condition and the
    referenced sign never change under the fix)."""
    if not levels.any():
        return levels
    from turingcodec_tpu_torch.decode.ctu_parse import _scan
    from turingcodec_tpu_torch.hevc.tables import LEVEL_SCALE
    n = 1 << log2
    out = levels.copy()
    pos = _scan(2, scan_idx)
    ls16 = (int(LEVEL_SCALE[qp % 6]) << (qp // 6)) * 16
    bd_shift = bit_depth + log2 - 5
    rnd = 1 << (bd_shift - 1)

    def dq(v):
        return (v * ls16 + rnd) >> bd_shift

    for ys in range(0, n, 4):
        for xs in range(0, n, 4):
            if not out[ys:ys + 4, xs:xs + 4].any():
                continue
            lv = [int(out[ys + int(pos[k, 1]), xs + int(pos[k, 0])])
                  for k in range(16)]
            nzk = [k for k in range(16) if lv[k]]
            first, last = nzk[0], nzk[-1]
            if last - first <= 3:
                continue
            sum_abs = sum(abs(v) for v in lv)
            want = 1 if lv[first] < 0 else 0
            if (sum_abs & 1) == want:
                continue
            best = None
            for k in range(16):
                x = xs + int(pos[k, 0])
                y = ys + int(pos[k, 1])
                v = int(out[y, x])
                c = float(coeffs[y, x])
                if k == first:
                    deltas = (1 if v > 0 else -1,)  # grow, keep sign
                elif first < k <= last:
                    if v == 0:
                        deltas = (1 if c >= 0 else -1,)
                    elif abs(v) == 1:
                        deltas = (1 if v > 0 else -1,)  # never zero a sig
                    else:
                        deltas = (1, -1)
                else:
                    continue
                for d in deltas:
                    cost = (float(dq(v + d)) - c) ** 2 \
                        - (float(dq(v)) - c) ** 2
                    if best is None or cost < best[0]:
                        best = (cost, y, x, v + d)
            _, y, x, nv = best
            out[y, x] = nv
    return out


@dataclass
class SearchInputs:
    """What a picture's analysis hands its search. The encoder facade
    fills it in its prepare phase (Encoder._fill_search_inputs); an empty
    record is the host path, where the native core computes its own
    fields."""
    # {list: (seed_mv, dense_mv, wb, hb, surf|None)}: each list's ref-0
    # seed field, dense full-pel field and SAD surface
    seeds: dict = field(default_factory=dict)
    # {list: (hb, wb)} the dense fields' winner SADs (the noise measure)
    dense_sads: dict = field(default_factory=dict)
    # {(list, ref): (15, ph, pw) int16} subpel planes
    subpel: Optional[dict] = None
    # {n: (hn, wn, 35) int32} source-referenced rank-SATD tables
    rank_tables: Optional[dict] = None
    # {list: source luma plane} the seeds were referenced against in
    # place of the ref-0 reconstruction (overlap)
    seed_src: dict = field(default_factory=dict)
    # inter-picture overlap: the plan the facade made ahead (dependent
    # pictures bind it) and this picture's published search-row counter
    overlap: bool = False
    preset_plan: Optional[PicturePlan] = None
    overlap_rows: Optional[np.ndarray] = None
    # per-CU AQ: each layer's QP map, and its full (luma, cb, cr) QPs
    aq_qp_layers: Optional[list] = None
    aq_layers_full: Optional[list] = None


class IntraPictureEncoder:
    """Encodes one picture, all-intra, fixed QP."""

    def __init__(self, sps: Sps, pps: Pps, sh: SliceSegmentHeader,
                 geom: PictureGeometry, rd_candidates: int = 3,
                 max_cu_log2: int = 5, use_rdoq: bool = False):
        self.sps, self.pps, self.sh, self.geom = sps, pps, sh, geom
        self.qp = sh.slice_qp_y
        self.qp_cb = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c, min(57, self.qp + pps.pps_cb_qp_offset)))
        self.qp_cr = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c, min(57, self.qp + pps.pps_cr_qp_offset)))
        self.bd = sps.bit_depth_y
        self.max_cu_log2 = min(max_cu_log2, sps.ctb_log2_size_y,
                               sps.max_tb_log2_size_y)
        self.rd_candidates = rd_candidates
        self.use_rdoq = use_rdoq
        # RCU-depth CU-range pruning (reference Search.hpp:721-806,
        # Speed.h useRcuDepth: on at medium/fast). Inter slices only; set
        # by the encoder facade. 0 = off.
        self.rcudepth = False
        self._rcu_status = 0
        # HM-style lambda for intra, fixed QP
        self.lam = 0.57 * (2.0 ** ((self.qp - 12) / 3.0))
        self.lam_bits = self.lam
        # search-side context pool for exact CABAC rate estimation; tracks
        # the real writer's context states exactly for EVERY bin — mode
        # bins (split/skip/pred/part/merge/mvd/...) and residual bins alike
        # (EstimateRate parity; checkRate invariant Write.h:820-826,
        # asserted per CTU by tests/test_rate_invariant.py)
        from turingcodec_tpu_torch.cabac.engine import ContextPool
        self.rd_ctx = ContextPool()
        self.rd_ctx.initialize(sh.init_type(), sh.slice_qp_y)
        self._rd_ctx_wpp = None
        # per-CTU committed fractional bits (1/256 units) of the chosen
        # path — integer, equals the writer's estimate re-walk exactly
        self._ctu_frac = 0
        self.ctu_frac_list = []
        # the slow preset (rd_candidates >= 3) refines candidates
        # ungated, like the reference (native twin keys off the same
        # condition)
        self._no_gate = rd_candidates >= 3
        self.qp_map = None  # per-CTB QP (adaptive quantization)
        self._base_lam_qp = self.qp
        # last 2Nx2N integer-search best per list (mvPreviousInteger2Nx2N
        # ME seed); row-local — reset at each CTU row start
        self._prev_int_mv = {}
        self.inputs = SearchInputs()

    def set_qp_map(self, qp_map):
        self.qp_map = qp_map

    def _set_cu_qp_layer(self, x0, y0, depth):
        """Per-CU AQ query (reference getAqOffset at min(cu_depth,
        aq_depth), Search.hpp:1145): QP only — the lambda stays at the
        CTB's layer-0 value, like the reference's picture lambda."""
        from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
        qls = self.inputs.aq_qp_layers
        d = min(depth, len(qls) - 1)
        sh_ = self.sps.ctb_log2_size_y - d
        q = int(qls[d][y0 >> sh_, x0 >> sh_])
        if q == self.qp:
            return
        sps, pps = self.sps, self.pps
        self.qp = q
        self.qp_cb = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c, min(57, q + pps.pps_cb_qp_offset)))
        self.qp_cr = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c, min(57, q + pps.pps_cr_qp_offset)))

    def _set_ctb_qp(self, qp: int):
        from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
        sps, pps = self.sps, self.pps
        scale = 2.0 ** ((qp - self._base_lam_qp) / 3.0)
        if not hasattr(self, "_lam0"):
            self._lam0 = self.lam
        self.qp = qp
        self.lam = self._lam0 * scale
        self.lam_bits = self.lam
        if hasattr(self, "lam_me"):
            import math
            self.lam_me = math.sqrt(self.lam)
        self.qp_cb = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c, min(57, qp + pps.pps_cb_qp_offset)))
        self.qp_cr = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c, min(57, qp + pps.pps_cr_qp_offset)))

    # ------------------------------------------------------------------
    def encode_picture(self, orig: List[np.ndarray], slice_number: int = 0
                       ) -> Tuple[PicturePlan, List[np.ndarray]]:
        sps, inputs = self.sps, self.inputs
        with TRACE.span("enc.search_setup"):
            # overlap mode pre-creates the plan in the facade's prepare phase
            # so dependent pictures' TMVP binds these tensors while this
            # picture is still encoding
            plan = inputs.preset_plan
            if plan is None:
                plan = PicturePlan(self.sps, self.pps)
            plan.slice_headers.append(self.sh)
            self.plan = plan
            self.orig = orig
            w = sps.pic_width_in_luma_samples
            h = sps.pic_height_in_luma_samples
            self.recon = [np.zeros((h, w), np.int16),
                          np.zeros((h // 2, w // 2), np.int16),
                          np.zeros((h // 2, w // 2), np.int16)]
            self.refs = ReferenceSampleBuilder(plan, self.geom)
            self.next_id = [0, 0, 0]
            plan.qp_y[:] = self.qp
            from turingcodec_tpu_torch import native
            nat = native.EncNative.try_create(self, plan)
            assert nat is not None or not inputs.overlap, \
                "inter-picture overlap requires the native search core"
            if nat is not None:
                if inputs.seeds:
                    nat.install_seeds(inputs.seeds)
                if inputs.subpel:
                    nat.install_subpel(inputs.subpel)
                if inputs.rank_tables:
                    nat.install_ranksatd(inputs.rank_tables)
                if inputs.overlap:
                    nat.setup_overlap(self)
                if inputs.aq_layers_full:
                    nat.install_aq(inputs.aq_layers_full)
        ctb = sps.ctb_size_y
        wpp = bool(self.pps.entropy_coding_sync_enabled_flag)
        wc = sps.pic_width_in_ctbs_y
        snap_rx = 1 if wc > 1 else 0
        row_slice = getattr(self, "slice_row_map", None)  # (hc,) slice of row
        ctu_rc = getattr(self, "ctu_rc", None)
        if (nat is not None and row_slice is None and ctu_rc is None
                and self.geom.num_tiles == 1):
            # whole-picture native walk (one ctypes call; WPP + AQ inside)
            plan.slice_idx[:] = slice_number
            if self.qp_map is not None:
                rep = ctb >> 2
                qm = np.repeat(np.repeat(self.qp_map, rep, 0), rep, 1)
                plan.qp_y[:] = qm[:plan.qp_y.shape[0], :plan.qp_y.shape[1]]
            nat.encode_picture_all(self)
            return plan, self.recon
        if self.geom.num_tiles > 1:
            # tiles (the Python search alone: the native core refuses
            # them): walk CTUs in tile-scan order; fresh rate contexts at
            # each tile start, ME seeds reset per tile-row (all derivation
            # availability is tile-aware via geom.zscan / tile_id maps)
            geom = self.geom
            for ts in range(geom.wc * geom.hc):
                rs = int(geom.tile_scan_ctus[ts])
                rx, ry = rs % wc, rs // wc
                tile = int(geom.tile_id[ry, rx])
                if rx == 0 or int(geom.tile_id[ry, rx - 1]) != tile:
                    self._prev_int_mv = {}  # ME seed state is row-local
                if ts > 0:
                    prs = int(geom.tile_scan_ctus[ts - 1])
                    if int(geom.tile_id[prs // wc, prs % wc]) != tile:
                        # mirror the writer's fresh CABAC at the tile start
                        self.rd_ctx.initialize(self.sh.init_type(),
                                               self.sh.slice_qp_y)
                plan.slice_idx[ry, rx] = slice_number
                if self.qp_map is not None:
                    q = int(self.qp_map[ry, rx])
                    self._set_ctb_qp(q)
                    plan.qp_y[ry * ctb >> 2:(ry + 1) * ctb >> 2,
                              rx * ctb >> 2:(rx + 1) * ctb >> 2] = q
                self._ctu_frac = 0
                self._decide_cqt(rx * ctb, ry * ctb, sps.ctb_log2_size_y, 0)
                self.ctu_frac_list.append(self._ctu_frac)
            return plan, self.recon
        for ry in range(sps.pic_height_in_ctbs_y):
            for rx in range(wc):
                if rx == 0:
                    # ME seed state is row-local (thread-count invariant)
                    self._prev_int_mv = {}
                if wpp and rx == 0 and ry > 0:
                    # mirror the writer's WPP context inheritance
                    if self._rd_ctx_wpp is not None:
                        self.rd_ctx.states = bytearray(self._rd_ctx_wpp.states)
                    else:
                        self.rd_ctx.initialize(self.sh.init_type(),
                                               self.sh.slice_qp_y)
                elif (row_slice is not None and rx == 0 and ry > 0
                        and row_slice[ry] != row_slice[ry - 1]):
                    # mirror the writer's fresh CABAC at an independent
                    # slice boundary (rate-estimation accuracy only)
                    self.rd_ctx.initialize(self.sh.init_type(),
                                           self.sh.slice_qp_y)
                plan.slice_idx[ry, rx] = (int(row_slice[ry])
                                          if row_slice is not None
                                          else slice_number)
                if ctu_rc is not None:
                    # CTU-level rate control (CtbController analogue,
                    # Write.h:745-765): per-CTB target bits -> lambda/QP
                    # before the search, model update from the exact
                    # committed rate after it
                    q = ctu_rc.pre_ctu(ry * wc + rx)
                    self._set_ctb_qp(q)
                    plan.qp_y[ry * ctb >> 2:(ry + 1) * ctb >> 2,
                              rx * ctb >> 2:(rx + 1) * ctb >> 2] = q
                elif self.qp_map is not None:
                    q = int(self.qp_map[ry, rx])
                    self._set_ctb_qp(q)
                    plan.qp_y[ry * ctb >> 2:(ry + 1) * ctb >> 2,
                              rx * ctb >> 2:(rx + 1) * ctb >> 2] = q
                if nat is not None:
                    nat.encode_ctu(self, rx * ctb, ry * ctb)
                else:
                    self._ctu_frac = 0
                    self._decide_cqt(rx * ctb, ry * ctb,
                                     sps.ctb_log2_size_y, 0)
                    self.ctu_frac_list.append(self._ctu_frac)
                if ctu_rc is not None:
                    ctu_rc.post_ctu(self.ctu_frac_list[-1] / 256.0)
                if wpp and rx == snap_rx:
                    self._rd_ctx_wpp = self.rd_ctx.copy()
        return plan, self.recon

    # ------------------------------------------------------------------
    def _decide_cqt(self, x0, y0, log2, depth) -> float:
        """Recursive split decision; commits into plan/recon; returns cost."""
        sps = self.sps
        w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        size = 1 << log2
        if depth == 0:
            # RCU-depth status from neighbour CtDepths at the CTU root
            # (Search.hpp:721-790). Out-of-picture neighbours read as
            # depth 0 (the reference's snake storage zero-initializes), so
            # top-row / left-column CTUs land on status 1.
            self._rcu_status = 0
            if self.rcudepth and not self.sh.is_i and (x0 or y0):
                ct = self.plan.ct_depth
                h4, w4 = ct.shape

                def d(px, py):
                    if px < 0 or py < 0:
                        return 0
                    return int(ct[min(py >> 2, h4 - 1),
                                  min(px >> 2, w4 - 1)])

                if x0 and y0:
                    stepx = 32 if x0 + size <= w else 16
                    stepy = 32 if y0 + size <= h else 16
                    ds = (d(x0, y0 - 1) + d(x0 + stepx, y0 - 1)
                          + d(x0 - 1, y0) + d(x0 - 1, y0 + stepy)
                          + d(x0 - 1, y0 - 1))
                    self._rcu_status = 1 if ds < 6 else (2 if ds < 14
                                                         else 3)
                elif x0:
                    stepx = 32 if x0 + size <= w else 16
                    ds = d(x0, y0 - 1) + d(x0 + stepx, y0 - 1)
                    self._rcu_status = 1 if ds < 4 else 2
                else:
                    stepy = 32 if y0 + size <= h else 16
                    ds = d(x0 - 1, y0) + d(x0 - 1, y0 + stepy)
                    self._rcu_status = 1 if ds < 4 else 2
        in_pic = x0 + size <= w and y0 + size <= h
        if not in_pic:
            if x0 >= w or y0 >= h:
                return 0.0
            cost = 0.0
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                if x0 + dx < w and y0 + dy < h:
                    cost += self._decide_cqt(x0 + dx, y0 + dy, log2 - 1,
                                             depth + 1)
            return cost
        if self.inputs.aq_qp_layers is not None:
            self._set_cu_qp_layer(x0, y0, depth)
        # intra pictures cap CUs at max_cu_log2; inter pictures search the
        # full CTB (64x64 skip/merge CUs are where B frames save bits —
        # the reference does the same)
        limit = self.max_cu_log2 if self.sh.is_i else \
            getattr(self, "max_cu_inter_log2", self.max_cu_log2)
        if log2 > limit:
            # 64x64 intra CU trial at slow (forced TU split; native twin)
            import os
            if (log2 == 6 and self.sh.is_i and self.rd_candidates >= 3
                    and not os.environ.get("TC_NO_I64")):
                state = self._snapshot(x0, y0, size)
                f0 = self._commit_split_flag(x0, y0, log2, depth, 0)
                cost_here = self._encode_cu64(x0, y0, depth) \
                    + self.lam * (f0 / 256.0)
                here = self._snapshot(x0, y0, size)
                self._restore(x0, y0, size, state)
                f1 = self._commit_split_flag(x0, y0, log2, depth, 1)
                cost_split = self.lam * (f1 / 256.0)
                half = size >> 1
                for (dx, dy) in ((0, 0), (half, 0), (0, half),
                                 (half, half)):
                    cost_split += self._decide_cqt(x0 + dx, y0 + dy,
                                                   log2 - 1, depth + 1)
                if cost_here <= cost_split:
                    self._restore(x0, y0, size, here)
                    return cost_here
                return cost_split
            f1 = self._commit_split_flag(x0, y0, log2, depth, 1)
            cost = self.lam * (f1 / 256.0)
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                cost += self._decide_cqt(x0 + dx, y0 + dy, log2 - 1, depth + 1)
            return cost

        # RCU-depth gates (Search.hpp:798-806): status 2/3 skips the
        # 64x64 full-CU trial, status 3 also skips 32x32; status 1 stops
        # the recursion below 16x16
        st = self._rcu_status
        if st and ((depth == 0 and st >= 2) or (depth == 1 and st == 3)):
            half = size >> 1
            f1 = self._commit_split_flag(x0, y0, log2, depth, 1)
            cost_split = self.lam * (f1 / 256.0)
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                cost_split += self._decide_cqt(x0 + dx, y0 + dy, log2 - 1,
                                               depth + 1)
            return cost_split

        # candidate: no-split at this size (split_cu_flag=0 committed
        # first — writer bin order is top-down)
        state = self._snapshot(x0, y0, size)
        f0 = self._commit_split_flag(x0, y0, log2, depth, 0)
        cost_here = self._encode_cu(x0, y0, log2, depth) \
            + self.lam * (f0 / 256.0)
        if log2 == sps.min_cb_log2_size_y:
            # try NxN at min CU size (four 4x4 intra PUs, DST transforms);
            # no split flag exists at the min CB size
            if self.sh.is_i or self.plan.cu_pred_mode[y0 >> 2, x0 >> 2] == 1:
                here = self._snapshot(x0, y0, size)
                self._restore(x0, y0, size, state)
                cost_nxn = self._encode_cu_nxn(x0, y0, log2, depth,
                                               budget=cost_here)
                if cost_nxn < cost_here:
                    return cost_nxn
                self._restore(x0, y0, size, here)
            return cost_here
        here = self._snapshot(x0, y0, size)
        # ECU (early CU termination, Speed.h ecu analogue; fast/medium):
        # a skip CU at this depth ends the split recursion
        if (self.rd_candidates <= 2 and not self.sh.is_i
                and self.plan.skip_flag[y0 >> 2, x0 >> 2]):
            return cost_here
        # RCU-depth: status 1 keeps the 16x16 result without trying 8x8
        if st == 1 and depth == 2:
            return cost_here
        self._restore(x0, y0, size, state)

        half = size >> 1
        f1 = self._commit_split_flag(x0, y0, log2, depth, 1)
        cost_split = self.lam * (f1 / 256.0)
        for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
            cost_split += self._decide_cqt(x0 + dx, y0 + dy, log2 - 1,
                                           depth + 1)
        if cost_here <= cost_split:
            self._restore(x0, y0, size, here)
            return cost_here
        return cost_split

    # ------------------------------------------------------------------
    def _snapshot(self, x0, y0, size):
        p = self.plan
        sl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
        cl = (slice(y0 >> 1, (y0 + size) >> 1), slice(x0 >> 1, (x0 + size) >> 1))
        ll = (slice(y0, y0 + size), slice(x0, x0 + size))
        return (
            [self.recon[0][ll].copy(), self.recon[1][cl].copy(),
             self.recon[2][cl].copy()],
            [p.ct_depth[sl].copy(), p.part_mode[sl].copy(),
             p.cu_pred_mode[sl].copy(), p.intra_mode_y[sl].copy(),
             p.intra_mode_c[sl].copy(), p.tu_log2[sl].copy(),
             p.tu_id[sl].copy(), p.cu_id[sl].copy(), p.pu_id[sl].copy(),
             p.cbf_y[sl].copy(), p.cbf_cb[sl].copy(), p.cbf_cr[sl].copy(),
             p.cu_size_log2[sl].copy(),
             p.coeff_y[ll].copy(), p.coeff_cb[cl].copy(),
             p.coeff_cr[cl].copy(),
             p.transform_skip_y[sl].copy(), p.transform_skip_cb[sl].copy(),
             p.transform_skip_cr[sl].copy()],
            list(self.next_id),
            bytearray(self.rd_ctx.states),
            self._ctu_frac,
        )

    def _restore(self, x0, y0, size, state):
        p = self.plan
        sl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
        cl = (slice(y0 >> 1, (y0 + size) >> 1), slice(x0 >> 1, (x0 + size) >> 1))
        ll = (slice(y0, y0 + size), slice(x0, x0 + size))
        rec, pl, ids, ctx_states, frac = state
        self.recon[0][ll], self.recon[1][cl], self.recon[2][cl] = \
            rec[0].copy(), rec[1].copy(), rec[2].copy()
        (p.ct_depth[sl], p.part_mode[sl], p.cu_pred_mode[sl],
         p.intra_mode_y[sl], p.intra_mode_c[sl], p.tu_log2[sl],
         p.tu_id[sl], p.cu_id[sl], p.pu_id[sl], p.cbf_y[sl], p.cbf_cb[sl],
         p.cbf_cr[sl], p.cu_size_log2[sl], p.coeff_y[ll], p.coeff_cb[cl],
         p.coeff_cr[cl], p.transform_skip_y[sl], p.transform_skip_cb[sl],
         p.transform_skip_cr[sl]) = [a.copy() for a in pl]
        self.next_id = list(ids)
        # the rate-context pool and frac counter follow the plan: a
        # discarded trial leaves no trace (the reference's CandidateStash
        # restores contexts the same way, StateEncode.h:380)
        self.rd_ctx.states = bytearray(ctx_states)
        self._ctu_frac = frac

    # ---- exact mode-bin rate machinery -------------------------------
    # Every syntax bin the writer will produce is estimated with the exact
    # context state and binarization (turing/EstimateRate.h:33-96 parity;
    # bypass bins cost exactly 1 bit). Estimators run either on a copy of
    # the live pool (candidate trials) or on the live pool itself
    # (committing the chosen path). Binarizations mirror encode/ctu_write.py
    # bin for bin.

    def _mb_est(self):
        """Estimator over a copy of the live pool (candidate trial)."""
        from turingcodec_tpu_torch.cabac.rate import RateEstimator
        return RateEstimator(self.rd_ctx.copy())

    def _mb_clone(self, est):
        """Fork an estimator (variant trials within one candidate)."""
        from turingcodec_tpu_torch.cabac.rate import RateEstimator
        e2 = RateEstimator(est.ctx.copy())
        e2.frac_bits = est.frac_bits
        return e2

    def _mb_live(self):
        """Estimator over the live pool (immediate commit)."""
        from turingcodec_tpu_torch.cabac.rate import RateEstimator
        return RateEstimator(self.rd_ctx)

    def _mb_adopt(self, est):
        """Adopt a copy-estimator's context evolution as the chosen path."""
        self.rd_ctx.states = est.ctx.states
        self._ctu_frac += est.frac_bits

    def _emit_split_flag(self, est, x0, y0, depth, split):
        """split_cu_flag bin (callers guard the writer's flag condition:
        in-picture node above the min CB size)."""
        plan = self.plan
        inc = 0
        if self.geom.available(plan.slice_idx, x0, y0, x0 - 1, y0):
            inc += int(plan.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth)
        if self.geom.available(plan.slice_idx, x0, y0, x0, y0 - 1):
            inc += int(plan.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth)
        est.encode_decision(ctx_index("split_cu_flag", inc), int(split))

    def _commit_split_flag(self, x0, y0, log2, depth, split):
        """Commit a split bin on the live pool; returns its frac bits."""
        if log2 <= self.sps.min_cb_log2_size_y:
            return 0
        est = self._mb_live()
        self._emit_split_flag(est, x0, y0, depth, split)
        self._ctu_frac += est.frac_bits
        return est.frac_bits

    def _emit_cu_skip(self, est, x0, y0, skip):
        plan = self.plan
        inc = 0
        if self.geom.available(plan.slice_idx, x0, y0, x0 - 1, y0):
            inc += int(plan.skip_flag[y0 >> 2, (x0 - 1) >> 2])
        if self.geom.available(plan.slice_idx, x0, y0, x0, y0 - 1):
            inc += int(plan.skip_flag[(y0 - 1) >> 2, x0 >> 2])
        est.encode_decision(ctx_index("cu_skip_flag", inc), int(skip))

    def _emit_merge_idx(self, est, idx):
        c_max = self.sh.max_num_merge_cand - 1
        est.encode_decision(ctx_index("merge_idx"), 1 if idx else 0)
        if idx:
            est.encode_bypass_bits(
                0, (idx - 1) + (1 if idx < c_max else 0))

    def _emit_skip_cu(self, est, x0, y0, idx):
        """Whole skip CU: cu_skip_flag=1 + merge_idx."""
        self._emit_cu_skip(est, x0, y0, 1)
        if self.sh.max_num_merge_cand > 1:
            self._emit_merge_idx(est, idx)

    def _emit_merge_pu(self, est, idx):
        est.encode_decision(ctx_index("merge_flag"), 1)
        if self.sh.max_num_merge_cand > 1:
            self._emit_merge_idx(est, idx)

    def _emit_mvd(self, est, mx, my):
        ax, ay = abs(mx), abs(my)
        est.encode_decision(ctx_index("abs_mvd_greater0_flag"), int(ax > 0))
        est.encode_decision(ctx_index("abs_mvd_greater0_flag"), int(ay > 0))
        if ax > 0:
            est.encode_decision(ctx_index("abs_mvd_greater1_flag"),
                                int(ax > 1))
        if ay > 0:
            est.encode_decision(ctx_index("abs_mvd_greater1_flag"),
                                int(ay > 1))
        for a in (ax, ay):
            if a > 0:
                if a > 1:
                    est.encode_egk_bypass(a - 2, 1)
                est.encode_bypass(0)  # sign

    def _emit_amvp_pu(self, est, cu_depth, pw, ph, info):
        """Non-merge prediction_unit bins (merge_flag=0, inter_pred_idc,
        ref_idx, mvd, mvp_flag); info: {lx: (mv, mvd, mvp_flag)}."""
        sh = self.sh
        est.encode_decision(ctx_index("merge_flag"), 0)
        ipi = (1 if 0 in info else 0) | (2 if 1 in info else 0)
        if sh.is_b:
            if pw + ph != 12:
                est.encode_decision(ctx_index("inter_pred_idc", cu_depth),
                                    1 if ipi == 3 else 0)
            if ipi != 3:
                est.encode_decision(ctx_index("inter_pred_idc", 4),
                                    1 if ipi == 2 else 0)
        for lx in (0, 1):
            if not (ipi >> lx) & 1:
                continue
            nref = (sh.num_ref_idx_l0_active_minus1 if lx == 0
                    else sh.num_ref_idx_l1_active_minus1)
            if nref > 0:
                est.encode_decision(ctx_index("ref_idx", 0), 0)  # ref 0
            if lx == 1 and sh.mvd_l1_zero_flag and ipi == 3:
                pass
            else:
                mvd_l = info[lx][1]
                self._emit_mvd(est, int(mvd_l[0]), int(mvd_l[1]))
            est.encode_decision(ctx_index("mvp_flag"), int(info[lx][2]))

    def _emit_inter_part_mode(self, est, part, log2):
        sps = self.sps
        if part == T.PART_2Nx2N:
            est.encode_decision(ctx_index("part_mode", 0), 1)
            return
        est.encode_decision(ctx_index("part_mode", 0), 0)
        at_min = log2 == sps.min_cb_log2_size_y
        amp = sps.amp_enabled_flag and not at_min
        horizontal = part in (T.PART_2NxN, T.PART_2NxnU, T.PART_2NxnD)
        est.encode_decision(ctx_index("part_mode", 1), 1 if horizontal else 0)
        if at_min:
            if part == T.PART_2NxN or log2 == 3:
                return
            est.encode_decision(ctx_index("part_mode", 2),
                                1 if part == T.PART_Nx2N else 0)
            return
        if not amp:
            return
        sym = part in (T.PART_2NxN, T.PART_Nx2N)
        est.encode_decision(ctx_index("part_mode", 3), 1 if sym else 0)
        if not sym:
            est.encode_bypass(0)

    def _emit_intra_luma_mode(self, est, mode, mpm):
        in_mpm = mode in mpm
        est.encode_decision(ctx_index("prev_intra_luma_pred_flag"),
                            int(in_mpm))
        if in_mpm:
            est.encode_bypass_bits(0, 1 if mpm.index(mode) == 0 else 2)
        else:
            est.encode_bypass_bits(0, 5)

    def _emit_chroma_mode(self, est, k):
        """Chroma mode bins by candidate-list position (0 = DM)."""
        est.encode_decision(ctx_index("intra_chroma_pred_mode"),
                            0 if k == 0 else 1)
        if k:
            est.encode_bypass_bits(0, 2)

    def _emit_cbf(self, est, elem, inc, val):
        est.encode_decision(ctx_index(elem, inc), int(val))

    def _emit_residual(self, est, levels, log2, c_idx, mode, intra, ts=0):
        """Chained residual bins (+ transform_skip flag when eligible) on
        the estimator's context pool. levels must be nonzero."""
        if self.pps.transform_skip_enabled_flag and log2 == 2:
            el = ("transform_skip_flag_luma" if c_idx == 0
                  else "transform_skip_flag_chroma")
            est.encode_decision(ctx_index(el), ts)
        scan = self._scan_for(log2, c_idx, mode, intra)
        sdh = bool(self.pps.sign_data_hiding_enabled_flag)
        from turingcodec_tpu_torch import native
        bits = native.residual_bits(est.ctx, log2, c_idx, scan, sdh, levels)
        if bits is not None:
            est.frac_bits += int(round(bits * 256.0))
        else:
            from turingcodec_tpu_torch.encode.ctu_write import residual_core
            residual_core(est, levels, log2, c_idx, scan, sdh)

    def _emit_tt_single(self, est, log2, lv_y, lv_cb, lv_cr, ts_cb=0,
                        ts_cr=0):
        """Single-TU inter transform tree bins (TU == CU, chroma at
        log2-1): split_transform_flag (when the writer emits one), chroma
        cbf, luma cbf, then the three residuals in writer order."""
        sps = self.sps
        if (log2 <= sps.max_tb_log2_size_y and log2 > sps.min_tb_log2_size_y
                and sps.max_transform_hierarchy_depth_inter > 0):
            est.encode_decision(ctx_index("split_transform_flag", 5 - log2),
                                0)
        my_cb, my_cr = int(lv_cb.any()), int(lv_cr.any())
        self._emit_cbf(est, "cbf_chroma", 0, my_cb)
        self._emit_cbf(est, "cbf_chroma", 0, my_cr)
        nz_y = int(lv_y.any())
        if my_cb or my_cr:
            self._emit_cbf(est, "cbf_luma", 1, nz_y)
        if nz_y:
            self._emit_residual(est, lv_y, log2, 0, 0, False)
        if my_cb:
            self._emit_residual(est, lv_cb, log2 - 1, 1, 0, False, ts_cb)
        if my_cr:
            self._emit_residual(est, lv_cr, log2 - 1, 2, 0, False, ts_cr)

    def _emit_tt_split(self, est, log2, lv_y, lv_cb, lv_cr):
        """One-level-split inter transform tree bins (four luma TUs at
        log2-1, chroma at log2-2 each) in writer z-order."""
        sps = self.sps
        if (log2 <= sps.max_tb_log2_size_y and log2 > sps.min_tb_log2_size_y
                and sps.max_transform_hierarchy_depth_inter > 0):
            est.encode_decision(ctx_index("split_transform_flag", 5 - log2),
                                1)
        my_cb, my_cr = int(lv_cb.any()), int(lv_cr.any())
        self._emit_cbf(est, "cbf_chroma", 0, my_cb)
        self._emit_cbf(est, "cbf_chroma", 0, my_cr)
        size = 1 << log2
        qh = size >> 1
        ch = qh >> 1
        for (dy, dx) in ((0, 0), (0, qh), (qh, 0), (qh, qh)):
            lq = lv_y[dy:dy + qh, dx:dx + qh]
            cdy, cdx = dy >> 1, dx >> 1
            lcb = lv_cb[cdy:cdy + ch, cdx:cdx + ch]
            lcr = lv_cr[cdy:cdy + ch, cdx:cdx + ch]
            q_cb, q_cr = int(lcb.any()), int(lcr.any())
            if my_cb:
                self._emit_cbf(est, "cbf_chroma", 1, q_cb)
            if my_cr:
                self._emit_cbf(est, "cbf_chroma", 1, q_cr)
            nzq = int(lq.any())
            self._emit_cbf(est, "cbf_luma", 0, nzq)
            if nzq:
                self._emit_residual(est, lq, log2 - 1, 0, 0, False)
            if q_cb:
                self._emit_residual(est, lcb, log2 - 2, 1, 0, False)
            if q_cr:
                self._emit_residual(est, lcr, log2 - 2, 2, 0, False)

    def _emit_tt_split8(self, est, lv_y, lv_cb, lv_cr):
        """8x8 inter CU with a one-level transform split: four 4x4 luma
        TUs but ONE 4x4 chroma TB pair (no chroma split below an 8x8
        luma; the writer's chroma_last path), in writer order."""
        sps = self.sps
        if (3 <= sps.max_tb_log2_size_y and 3 > sps.min_tb_log2_size_y
                and sps.max_transform_hierarchy_depth_inter > 0):
            est.encode_decision(ctx_index("split_transform_flag", 2), 1)
        my_cb, my_cr = int(lv_cb.any()), int(lv_cr.any())
        self._emit_cbf(est, "cbf_chroma", 0, my_cb)
        self._emit_cbf(est, "cbf_chroma", 0, my_cr)
        for (dy, dx) in ((0, 0), (0, 4), (4, 0), (4, 4)):
            lq = lv_y[dy:dy + 4, dx:dx + 4]
            nzq = int(lq.any())
            self._emit_cbf(est, "cbf_luma", 0, nzq)
            if nzq:
                self._emit_residual(est, lq, 2, 0, 0, False)
        if my_cb:
            self._emit_residual(est, lv_cb, 2, 1, 0, False)
        if my_cr:
            self._emit_residual(est, lv_cr, 2, 2, 0, False)

    # ------------------------------------------------------------------
    def _encode_cu(self, x0, y0, log2, depth, budget=None) -> float:
        """Commit the best 2Nx2N intra CU at (x0, y0); returns RD cost.

        budget (inter pictures; native twin): inter champion's RD cost
        less the pred_mode-flag bits — when even the best SATD ranking
        cost reaches it the RD refinement is skipped (the caller's
        snapshot restore rolls back the partial commit)."""
        from turingcodec_tpu_torch.decode.ctu_parse import _intra_mpm_n

        plan, sps = self.plan, self.sps
        size = 1 << log2
        sl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
        plan.ct_depth[sl] = depth
        plan.cu_pred_mode[sl] = 1
        plan.part_mode[sl] = 0
        plan.cu_size_log2[sl] = log2
        plan.cu_id[sl] = self.next_id[0]
        plan.pu_id[sl] = self.next_id[1]
        self.next_id[0] += 1
        self.next_id[1] += 1

        # CU-level mode bins (committed up front; the caller's snapshot
        # rolls them back if this trial loses): cu_skip_flag=0 +
        # pred_mode_flag=1 in inter slices, part_mode=2Nx2N at min CB size
        head = self._mb_live()
        if not self.sh.is_i:
            self._emit_cu_skip(head, x0, y0, 0)
            head.encode_decision(ctx_index("pred_mode_flag"), 1)
        if log2 == sps.min_cb_log2_size_y:
            head.encode_decision(ctx_index("part_mode", 0), 1)
        self._ctu_frac += head.frac_bits
        head_bits = self.lam * (head.frac_bits / 256.0)

        orig_y = self.orig[0][y0:y0 + size, x0:x0 + size].astype(np.int32)

        # SATD sweep over all 35 modes, batched (encode/sweep.py)
        rt, rl, corner = self.refs.build(self.recon[0], x0, y0, size, 0, self.bd)
        if self._use_src_rank():
            # MET presets rank with SOURCE-referenced neighbours (native
            # twin; pure positional function of the input picture);
            # refinement keeps the exact recon refs above
            srt, srl, scorner = self.refs.build(self.orig[0], x0, y0,
                                                size, 0, self.bd)
        else:
            srt, srl, scorner = rt, rl, corner

        class _PS:
            pass
        ps = _PS()
        ps.plan, ps.geom, ps.sps = plan, self.geom, sps
        mpm, n_mpm = _intra_mpm_n(ps, x0, y0)
        # Speed.h nCandidatesIntraRefinement: slow 8; medium 3 above 8x8
        # else 8; fast 3 above 8x8 else 4
        ncand = 8 if self.rd_candidates >= 3 else (
            3 if log2 > 3 else (8 if self.rd_candidates == 2 else 4))
        cands, ccosts = self._rank_modes(
            orig_y, srt, srl, scorner, size, mpm, count=ncand,
            n_mpm=n_mpm if self.sh.is_i else 0)
        if not self._no_gate and budget is not None \
                and ccosts[0] >= budget:
            return float("inf")

        best = None
        for k, mode in enumerate(cands):
            # SATD-gate (native enc_core twin): a candidate whose ranking
            # cost is already 1.5x the leader's essentially never wins the
            # RD refinement; planar is exempt. Second clause: adaptive stop
            # once the achieved RD cost undercuts the next candidate's
            # SATD ranking cost.
            if not self._no_gate and k > 0 and mode != 0 and (
                    ccosts[k] > 1.5 * ccosts[0]
                    or (best is not None and best[0] <= ccosts[k])):
                continue
            frt, frl, fc = filter_reference_samples(
                rt, rl, corner, size, mode,
                bool(sps.strong_intra_smoothing_enabled_flag), self.bd)
            pred = intra_predict(mode, frt, frl, fc, size, 0, self.bd)
            res = orig_y - pred
            use_dst = log2 == 2
            coeffs = forward_transform_np(res, self.bd, use_dst)
            levels = self._quantize_rd(coeffs, self.qp + sps.qp_bd_offset_y,
                                       self.bd, log2, True, 0, mode,
                                       cbf=("cbf_luma", 1))
            if levels.any():
                d = dequant_block(levels, self.qp + sps.qp_bd_offset_y,
                                  self.bd, log2)
                rec_res = inverse_transform(d, self.bd, use_dst)
                rec = np.clip(pred + rec_res, 0, (1 << self.bd) - 1)
            else:
                rec = np.clip(pred, 0, (1 << self.bd) - 1)
            dist = float(((rec - orig_y) ** 2).sum())
            est = self._mb_est()
            self._emit_intra_luma_mode(est, mode, mpm)
            self._emit_cbf(est, "cbf_luma", 1, levels.any())
            if levels.any():
                self._emit_residual(est, levels, log2, 0, mode, True)
            cost = dist + self.lam * (est.frac_bits / 256.0)
            if best is None or cost < best[0]:
                best = (cost, mode, levels, rec, est)

        cost, mode, levels, rec, best_est = best
        cost += head_bits
        self._mb_adopt(best_est)
        plan.intra_mode_y[sl] = mode
        plan.tu_log2[sl] = log2
        plan.tu_id[sl] = self.next_id[2]
        self.next_id[2] += 1
        plan.coeff_y[y0:y0 + size, x0:x0 + size] = levels
        plan.cbf_y[sl] = int(levels.any())
        self.recon[0][y0:y0 + size, x0:x0 + size] = rec

        # chroma: candidate-searched mode, half res
        cost += self._encode_chroma(plan, sl, x0, y0, size, mode, log2 - 1)
        return cost

    # ------------------------------------------------------------------
    def _mode_satds(self, orig_b, rt, rl, corner, n):
        """Per-mode Hadamard SATDs of all 35 predictions (the _rank_modes
        core without the mode-bit bias; spec 8.4.4.2.3 per-mode edge
        filtering)."""
        from turingcodec_tpu_torch.decode.reconstruct import _HVD_THRES
        from turingcodec_tpu_torch.encode.sweep import intra_all_modes_np, satd_many
        sps = self.sps
        preds = intra_all_modes_np(rt, rl, corner, n, self.bd)
        if n > 4:
            frt, frl, fc = filter_reference_samples(
                rt, rl, corner, n, 0,
                bool(sps.strong_intra_smoothing_enabled_flag), self.bd)
            preds_f = intra_all_modes_np(frt, frl, fc, n, self.bd)
            thres = _HVD_THRES[n]
            for mode in range(35):
                if mode == 1:
                    continue
                if mode != 0 and min(abs(mode - 26),
                                     abs(mode - 10)) <= thres:
                    continue
                preds[mode] = preds_f[mode]
        return satd_many(orig_b, preds, 8 if n >= 8 else 4)

    def _encode_chroma64(self, plan, x0, y0, dm):
        """Chroma half of a 64x64 intra CU: four 16x16 TB pairs under the
        depth-0 chroma cbf, reconstructed sequentially (native twin:
        intra_chroma64)."""
        sps = self.sps
        cx, cy = x0 >> 1, y0 >> 1
        cand = [dm, 0, 26, 10, 1]
        cand[1:] = [34 if c == dm else c for c in cand[1:]]
        z4 = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)
        planes = ((self.orig[1], self.recon[1], plan.coeff_cb, plan.cbf_cb,
                   self.qp_cb),
                  (self.orig[2], self.recon[2], plan.coeff_cr, plan.cbf_cr,
                   self.qp_cr))
        base_rec = [self.recon[c][cy:cy + 32, cx:cx + 32].copy()
                    for c in (1, 2)]
        best = None
        for k, m in enumerate(cand):
            dist = 0.0
            lv_q = [[None] * 4 for _ in range(2)]
            nz_q = [[0] * 4 for _ in range(2)]
            for q in range(4):
                qx, qy = cx + z4[q][1] * 16, cy + z4[q][0] * 16
                for ci, (plane_o, _r, _c, _f, qp) in enumerate(planes):
                    rt_c, rl_c, c_c = self.refs.build(
                        self.recon[ci + 1], qx, qy, 16, 1,
                        sps.bit_depth_c)
                    pred = intra_predict(m, rt_c, rl_c, c_c, 16, 1,
                                         sps.bit_depth_c)
                    orig_c = plane_o[qy:qy + 16, qx:qx + 16] \
                        .astype(np.int32)
                    res = orig_c - pred
                    coeffs = forward_transform_np(res, sps.bit_depth_c,
                                                  False)
                    levels = self._quantize_rd(
                        coeffs, qp + sps.qp_bd_offset_c, sps.bit_depth_c,
                        4, True, ci + 1, m, cbf=("cbf_chroma", 1))
                    if levels.any():
                        d = dequant_block(levels, qp + sps.qp_bd_offset_c,
                                          sps.bit_depth_c, 4)
                        rec_c = np.clip(
                            pred + inverse_transform(d, sps.bit_depth_c,
                                                     False),
                            0, (1 << sps.bit_depth_c) - 1)
                    else:
                        rec_c = np.clip(pred, 0, (1 << sps.bit_depth_c) - 1)
                    dist += float(((rec_c - orig_c) ** 2).sum())
                    lv_q[ci][q] = levels
                    nz_q[ci][q] = int(levels.any())
                    self.recon[ci + 1][qy:qy + 16, qx:qx + 16] = rec_c
            est = self._mb_est()
            self._emit_chroma_mode(est, k)
            p_cb = int(any(nz_q[0]))
            p_cr = int(any(nz_q[1]))
            self._emit_cbf(est, "cbf_chroma", 0, p_cb)
            self._emit_cbf(est, "cbf_chroma", 0, p_cr)
            for q in range(4):
                if p_cb:
                    self._emit_cbf(est, "cbf_chroma", 1, nz_q[0][q])
                if p_cr:
                    self._emit_cbf(est, "cbf_chroma", 1, nz_q[1][q])
                if nz_q[0][q]:
                    self._emit_residual(est, lv_q[0][q], 4, 1, m, True)
                if nz_q[1][q]:
                    self._emit_residual(est, lv_q[1][q], 4, 2, m, True)
            ck = dist + self.lam * (est.frac_bits / 256.0)
            if best is None or ck < best[0]:
                best = (ck, k, m, lv_q, nz_q, est,
                        [self.recon[c][cy:cy + 32, cx:cx + 32].copy()
                         for c in (1, 2)])
            if k < 4:
                for i, c in enumerate((1, 2)):
                    self.recon[c][cy:cy + 32, cx:cx + 32] = base_rec[i]
        ck, _k, m, lv_q, nz_q, est, rec = best
        self._mb_adopt(est)
        sl64 = (slice(y0 >> 2, (y0 + 64) >> 2),
                slice(x0 >> 2, (x0 + 64) >> 2))
        plan.intra_mode_c[sl64] = m
        for ci, (_o, _r, coeffp, cbfp, _q) in enumerate(planes):
            for q in range(4):
                qx, qy = cx + z4[q][1] * 16, cy + z4[q][0] * 16
                coeffp[qy:qy + 16, qx:qx + 16] = lv_q[ci][q]
                qsl = (slice((y0 + z4[q][0] * 32) >> 2,
                             (y0 + z4[q][0] * 32 + 32) >> 2),
                       slice((x0 + z4[q][1] * 32) >> 2,
                             (x0 + z4[q][1] * 32 + 32) >> 2))
                cbfp[qsl] = nz_q[ci][q]
            self.recon[ci + 1][cy:cy + 32, cx:cx + 32] = rec[ci]
        return ck

    def _encode_cu64(self, x0, y0, depth):
        """64x64 intra CU with the forced transform split (native twin:
        encode_intra_cu64; Search.hpp:374): four 32x32 TUs sharing one
        luma mode, ranked with SOURCE-referenced quadrant SATDs and
        refined with sequential exact-recon reconstruction."""
        plan, sps = self.plan, self.sps
        sl = (slice(y0 >> 2, (y0 + 64) >> 2),
              slice(x0 >> 2, (x0 + 64) >> 2))
        plan.ct_depth[sl] = depth
        plan.cu_pred_mode[sl] = 1
        plan.part_mode[sl] = 0
        plan.cu_size_log2[sl] = 6
        plan.cu_id[sl] = self.next_id[0]
        plan.pu_id[sl] = self.next_id[1]
        self.next_id[0] += 1
        self.next_id[1] += 1
        head = self._mb_live()
        if not self.sh.is_i:
            self._emit_cu_skip(head, x0, y0, 0)
            head.encode_decision(ctx_index("pred_mode_flag"), 1)
        self._ctu_frac += head.frac_bits
        head_bits = self.lam * (head.frac_bits / 256.0)

        from turingcodec_tpu_torch.decode.ctu_parse import _intra_mpm_n

        class _PS:
            pass
        ps = _PS()
        ps.plan, ps.geom, ps.sps = plan, self.geom, sps
        mpm, _n_mpm = _intra_mpm_n(ps, x0, y0)
        z4 = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)
        orig_q = []
        satd = []
        for q in range(4):
            qx, qy = x0 + z4[q][1] * 32, y0 + z4[q][0] * 32
            ob = self.orig[0][qy:qy + 32, qx:qx + 32].astype(np.int32)
            orig_q.append(ob)
            srt, srl, sc = self.refs.build(self.orig[0], qx, qy, 32, 0,
                                           self.bd)
            satd.append(self._mode_satds(ob, srt, srl, sc, 32))
        costs = [float(int(satd[0][m]) + int(satd[1][m]) + int(satd[2][m])
                       + int(satd[3][m]))
                 + self.lam_bits * (2.0 if m in mpm else 6.0)
                 for m in range(35)]
        ncand = 8 if self.rd_candidates >= 3 else 3
        cands = sorted(range(35), key=lambda m: (costs[m], m))[:ncand]

        base_rec = self.recon[0][y0:y0 + 64, x0:x0 + 64].copy()
        best = None
        for k, mode in enumerate(cands):
            est = self._mb_est()
            self._emit_intra_luma_mode(est, mode, mpm)
            dist = 0.0
            lv_q, nz_q = [], []
            for q in range(4):
                qx, qy = x0 + z4[q][1] * 32, y0 + z4[q][0] * 32
                rt, rl, corner = self.refs.build(self.recon[0], qx, qy,
                                                 32, 0, self.bd)
                frt, frl, fc = filter_reference_samples(
                    rt, rl, corner, 32, mode,
                    bool(sps.strong_intra_smoothing_enabled_flag),
                    self.bd)
                pred = intra_predict(mode, frt, frl, fc, 32, 0, self.bd)
                res = orig_q[q] - pred
                coeffs = forward_transform_np(res, self.bd, False)
                levels = self._quantize_rd(coeffs,
                                           self.qp + sps.qp_bd_offset_y,
                                           self.bd, 5, True, 0, mode,
                                           cbf=("cbf_luma", 0))
                if levels.any():
                    d = dequant_block(levels,
                                      self.qp + sps.qp_bd_offset_y,
                                      self.bd, 5)
                    rec = np.clip(pred + inverse_transform(d, self.bd,
                                                           False),
                                  0, (1 << self.bd) - 1)
                else:
                    rec = np.clip(pred, 0, (1 << self.bd) - 1)
                dist += float(((rec - orig_q[q]) ** 2).sum())
                self.recon[0][qy:qy + 32, qx:qx + 32] = rec
                lv_q.append(levels)
                nz_q.append(int(levels.any()))
                self._emit_cbf(est, "cbf_luma", 0, nz_q[q])
                if nz_q[q]:
                    self._emit_residual(est, levels, 5, 0, mode, True)
            cost = dist + self.lam * (est.frac_bits / 256.0)
            if best is None or cost < best[0]:
                best = (cost, mode, lv_q, nz_q, est,
                        self.recon[0][y0:y0 + 64, x0:x0 + 64].copy())
            if k < len(cands) - 1:
                self.recon[0][y0:y0 + 64, x0:x0 + 64] = base_rec
        cost, mode, lv_q, nz_q, best_est, rec = best
        self._mb_adopt(best_est)
        cost += head_bits
        plan.intra_mode_y[sl] = mode
        plan.tu_log2[sl] = 5
        for q in range(4):
            qx, qy = x0 + z4[q][1] * 32, y0 + z4[q][0] * 32
            qsl = (slice(qy >> 2, (qy + 32) >> 2),
                   slice(qx >> 2, (qx + 32) >> 2))
            plan.tu_id[qsl] = self.next_id[2]
            self.next_id[2] += 1
            plan.coeff_y[qy:qy + 32, qx:qx + 32] = lv_q[q]
            plan.cbf_y[qsl] = nz_q[q]
        self.recon[0][y0:y0 + 64, x0:x0 + 64] = rec
        return cost + self._encode_chroma64(plan, x0, y0, mode)

    def _use_src_rank(self) -> bool:
        """Source-referenced SATD ranking (enc_core twin): at MET presets
        (rd_candidates <= 2)."""
        return self.rd_candidates <= 2

    def _rank_modes(self, orig_b, rt, rl, corner, n, mpm, count=None,
                    n_mpm=0):
        """SATD-rank all 35 modes with one batched prediction+SATD pass.

        Per-mode reference filtering follows spec 8.4.4.2.3 (the RD
        refinement recomputes exact predictions, edge filters included)."""
        satds = self._mode_satds(orig_b, rt, rl, corner, n)
        mode_bits = np.array([2 if m in mpm else 6 for m in range(35)])
        costs = satds + self.lam_bits * mode_bits
        order = np.argsort(costs, kind="stable")
        cands = [int(m) for m in order[: count or self.rd_candidates]]
        ccosts = [float(costs[m]) for m in cands]
        if 0 not in cands and len(cands) >= 2:
            cands[-1] = 0  # always try planar
            ccosts[-1] = float(costs[0])
        # the reference appends the unsearched NEIGHBOUR modes (the first
        # candModeList.neighbourModes entries) to the RD refinement list
        # with ranking cost 0 — always refined, never SATD-gated
        # (Search.hpp:180-190; CandModeList.h neighbourModes). On
        # re-encoded content this carries the originally-coded mode into
        # the RD trial, where requantization is near-idempotent.
        for m in mpm[:n_mpm]:
            if m not in cands:
                cands.append(int(m))
                ccosts.append(0.0)
        return cands, ccosts

    # ------------------------------------------------------------------
    def _encode_cu_nxn(self, x0, y0, log2, depth, budget=None) -> float:
        """Intra NxN at min CU size: four 4x4 PUs/TUs (DST) + 4x4 chroma."""
        from turingcodec_tpu_torch.decode.ctu_parse import _intra_mpm_n

        plan, sps = self.plan, self.sps
        size = 1 << log2
        half = size >> 1
        sl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
        plan.ct_depth[sl] = depth
        plan.cu_pred_mode[sl] = 1
        plan.part_mode[sl] = 3  # PART_NxN
        plan.cu_size_log2[sl] = log2
        plan.cu_id[sl] = self.next_id[0]
        self.next_id[0] += 1
        plan.ref_idx[(0,) + sl] = -1
        plan.ref_idx[(1,) + sl] = -1

        # CU-level mode bins (see _encode_cu); part_mode bin = 0 (NxN)
        head = self._mb_live()
        if not self.sh.is_i:
            self._emit_cu_skip(head, x0, y0, 0)
            head.encode_decision(ctx_index("pred_mode_flag"), 1)
        head.encode_decision(ctx_index("part_mode", 0), 0)
        self._ctu_frac += head.frac_bits
        head_bits = self.lam * (head.frac_bits / 256.0)

        class _PS:
            pass
        ps = _PS()
        ps.plan, ps.geom, ps.sps = plan, self.geom, sps

        cost = head_bits
        modes = []
        lumas = []
        for i in range(4):
            xb = x0 + (i & 1) * half
            yb = y0 + (i >> 1) * half
            bl = (slice(yb >> 2, (yb + half) >> 2),
                  slice(xb >> 2, (xb + half) >> 2))
            plan.pu_id[bl] = self.next_id[1]
            self.next_id[1] += 1
            orig_b = self.orig[0][yb:yb + half, xb:xb + half].astype(np.int32)
            rt, rl, corner = self.refs.build(self.recon[0], xb, yb, half, 0,
                                             self.bd)
            if self._use_src_rank():
                srt, srl, scorner = self.refs.build(self.orig[0], xb, yb,
                                                    half, 0, self.bd)
            else:
                srt, srl, scorner = rt, rl, corner
            mpm, n_mpm = _intra_mpm_n(ps, xb, yb)
            cands, ccosts = self._rank_modes(
                orig_b, srt, srl, scorner, half, mpm,
                count=8 if self.rd_candidates >= 2 else 4,
                n_mpm=n_mpm if self.sh.is_i else 0)
            # NxN budget bail (native twin): committed sub-PU costs plus
            # this sub-PU's best SATD ranking cost already lose to the
            # 8x8 winner
            if not self._no_gate and budget is not None \
                    and cost + ccosts[0] >= budget:
                return float("inf")
            ts_on = bool(self.pps.transform_skip_enabled_flag)
            best = None
            for k, mode in enumerate(cands):
                # SATD-gate (native enc_core twin; planar exempt) + the
                # adaptive achieved-RD-vs-next-SATD stop
                if not self._no_gate and k > 0 and mode != 0 and (
                        ccosts[k] > 1.5 * ccosts[0]
                        or (best is not None and best[0] <= ccosts[k])):
                    continue
                pred = intra_predict(mode, rt, rl, corner, half, 0, self.bd)
                res = orig_b - pred
                coeffs = forward_transform_np(res, self.bd, True)
                levels = self._quantize_rd(coeffs,
                                           self.qp + sps.qp_bd_offset_y,
                                           self.bd, 2, True, 0, mode,
                                           cbf=("cbf_luma", 0))
                if levels.any():
                    d = dequant_block(levels, self.qp + sps.qp_bd_offset_y,
                                      self.bd, 2)
                    rec = np.clip(pred + inverse_transform(d, self.bd, True),
                                  0, (1 << self.bd) - 1)
                else:
                    rec = np.clip(pred, 0, (1 << self.bd) - 1)
                variants = [(levels, rec, 0)]
                if ts_on:
                    variants.append(self._ts_variant(
                        res, pred, self.qp + sps.qp_bd_offset_y, self.bd,
                        0, mode, True, ("cbf_luma", 0)) + (1,))
                for lv_v, rec_v, tsf in variants:
                    dist = float(((rec_v - orig_b) ** 2).sum())
                    est = self._mb_est()
                    self._emit_intra_luma_mode(est, mode, mpm)
                    self._emit_cbf(est, "cbf_luma", 0, lv_v.any())
                    if lv_v.any():
                        self._emit_residual(est, lv_v, 2, 0, mode, True,
                                            tsf)
                    c = dist + self.lam * (est.frac_bits / 256.0)
                    if best is None or c < best[0]:
                        best = (c, mode, lv_v, rec_v, tsf, est)
            c, mode, levels, rec, tsf, best_est = best
            plan.transform_skip_y[yb >> 2, xb >> 2] = \
                tsf if levels.any() else 0
            self._mb_adopt(best_est)
            cost += c
            modes.append(mode)
            plan.intra_mode_y[bl] = mode
            plan.tu_log2[bl] = 2
            plan.tu_id[bl] = self.next_id[2]
            self.next_id[2] += 1
            plan.coeff_y[yb:yb + half, xb:xb + half] = levels
            plan.cbf_y[bl] = int(levels.any())
            self.recon[0][yb:yb + half, xb:xb + half] = rec
            lumas.append(rec)

        # chroma: candidate-searched mode, one 4x4 TB pair for the CU
        cost += self._encode_chroma(plan, sl, x0, y0, size, modes[0], 2)
        return cost

    # ------------------------------------------------------------------
    def _encode_chroma(self, plan, sl, x0, y0, size, dm, clog2):
        """Chroma mode search (searchIntraChroma, Search.hpp:271): DM +
        planar/vertical/horizontal/DC (34 substituted for a DM duplicate),
        each fully reconstructed and RD-costed; mode bits 1 (DM) / 3 (list
        entry) match the writer's binarization. Sets intra_mode_c and
        returns dist + lam * bits (native twin: intra_chroma)."""
        sps = self.sps
        cx, cy, cs = x0 >> 1, y0 >> 1, size >> 1
        cand = [dm, 0, 26, 10, 1]
        cand[1:] = [34 if c == dm else c for c in cand[1:]]
        planes = ((self.orig[1], self.recon[1], plan.coeff_cb, plan.cbf_cb,
                   self.qp_cb),
                  (self.orig[2], self.recon[2], plan.coeff_cr, plan.cbf_cr,
                   self.qp_cr))
        refs = [self.refs.build(p[1], cx, cy, cs, 1, sps.bit_depth_c)
                for p in planes]
        ts_on = (clog2 == 2
                 and bool(self.pps.transform_skip_enabled_flag))
        # SATD pre-ranking gate (native intra_chroma twin): predict all 5
        # candidates for both planes, rank by SATD + mode bits, RD-evaluate
        # only the top 2 (ties to the lower index)
        from turingcodec_tpu_torch.encode.sweep import satd_many
        preds = {}
        gate = []
        cblk = 8 if cs >= 8 else 4
        for k, m in enumerate(cand):
            s = 0
            for c_idx, (plane_o, _r, _c, _f, _q) in enumerate(planes):
                rt_c, rl_c, c_c = refs[c_idx]
                p = intra_predict(m, rt_c, rl_c, c_c, cs, 1,
                                  sps.bit_depth_c)
                preds[(k, c_idx)] = p
                orig_c = plane_o[cy:cy + cs, cx:cx + cs].astype(np.int32)
                s += int(satd_many(orig_c, p[None].astype(np.int32),
                                   cblk)[0])
            gate.append(float(s) + self.lam_bits * (1.0 if k == 0 else 3.0))
        order = sorted(range(5), key=lambda k: (gate[k], k))
        keep = set(order[:2])
        best = None
        for k, m in enumerate(cand):
            if not self._no_gate and k not in keep:
                continue
            trials = []
            est = self._mb_est()
            self._emit_chroma_mode(est, k)
            ck = self.lam * (est.frac_bits / 256.0)  # mode bins
            for c_idx, (plane_o, _r, _c, _f, qp) in enumerate(planes):
                pred = preds[(k, c_idx)]
                res = plane_o[cy:cy + cs, cx:cx + cs].astype(np.int32) - pred
                coeffs = forward_transform_np(res, sps.bit_depth_c, False)
                levels = self._quantize_rd(coeffs, qp + sps.qp_bd_offset_c,
                                           sps.bit_depth_c, clog2, True,
                                           c_idx + 1, m,
                                           cbf=("cbf_chroma", 0))
                if levels.any():
                    d = dequant_block(levels, qp + sps.qp_bd_offset_c,
                                      sps.bit_depth_c, clog2)
                    rec_c = np.clip(
                        pred + inverse_transform(d, sps.bit_depth_c, False),
                        0, (1 << sps.bit_depth_c) - 1)
                else:
                    rec_c = np.clip(pred, 0, (1 << sps.bit_depth_c) - 1)
                variants = [(levels, rec_c, 0)]
                if ts_on:
                    variants.append(self._ts_variant(
                        res, pred, qp + sps.qp_bd_offset_c,
                        sps.bit_depth_c, c_idx + 1, m, True,
                        ("cbf_chroma", 0)) + (1,))
                cbest = None
                base_frac = est.frac_bits
                for lv_v, rec_v, tsf in variants:
                    dist_c = float(
                        ((rec_v - plane_o[cy:cy + cs, cx:cx + cs]) ** 2)
                        .sum())
                    e2 = self._mb_clone(est)
                    self._emit_cbf(e2, "cbf_chroma", 0, lv_v.any())
                    if lv_v.any():
                        self._emit_residual(e2, lv_v, clog2, c_idx + 1, m,
                                            True, tsf)
                    cc = dist_c \
                        + self.lam * ((e2.frac_bits - base_frac) / 256.0)
                    if cbest is None or cc < cbest[0]:
                        cbest = (cc, lv_v, rec_v, tsf, e2)
                ck += cbest[0]
                trials.append(cbest[1:4])
                est = cbest[4]  # chain cr's bins on the chosen cb's ctx
            if best is None or ck < best[0]:
                best = (ck, m, trials, est)
        ck, m, trials, best_est = best
        self._mb_adopt(best_est)
        plan.intra_mode_c[sl] = m
        for c_idx, (_o, plane_r, coeffp, cbfp, _q) in enumerate(planes):
            levels, rec_c, tsf = trials[c_idx]
            coeffp[cy:cy + cs, cx:cx + cs] = levels
            cbfp[sl] = int(levels.any())
            plane_r[cy:cy + cs, cx:cx + cs] = rec_c
            if ts_on:
                tsmap = (plan.transform_skip_cb if c_idx == 0
                         else plan.transform_skip_cr)
                tsmap[cy >> 1, cx >> 1] = tsf if levels.any() else 0
        return ck

    # ------------------------------------------------------------------
    def _ts_variant(self, res, pred, qp_full, bd, c_idx, mode, intra,
                    cbf):
        """Transform-skip 4x4 TB variant (--tskip; Reconstruct.cpp:426-497):
        forward coeff = res << (13 - bd), the usual quantizer, recon via
        the spec 8.6.4.1 shift. Returns (levels, rec)."""
        coeffs = res.astype(np.int64) << (13 - bd)
        levels = self._quantize_rd(coeffs, qp_full, bd, 2, intra, c_idx,
                                   mode, cbf=cbf)
        if levels.any():
            d = dequant_block(levels, qp_full, bd, 2)
            bds = 20 - bd
            rr = np.clip(
                ((d.astype(np.int64) << 7) + (1 << (bds - 1))) >> bds,
                -32768, 32767).astype(np.int32)
            rec = np.clip(pred + rr, 0, (1 << bd) - 1)
        else:
            rec = np.clip(pred, 0, (1 << bd) - 1)
        return levels, rec

    # ------------------------------------------------------------------
    def _quantize_rd(self, coeffs, qp, bd, log2, intra, c_idx, mode,
                     cbf=("cbf_luma", 0)):
        """Quantize (plain or HM RDOQ) + sign-data-hiding parity fix —
        the one quantization entry point of every search path.

        Plain path: deadzone offset follows the SLICE type, not the CU
        prediction mode: 1/3 in I slices, 1/6 in P/B (Reconstruct.cpp:439
        `h[slice_type()] == I ? 171 : 85`). RDOQ path: full HM RDOQ
        (encode/rdoq.py; Rdoq.cpp:35-444) against the live rate-context
        pool; `cbf` names the flag gating an all-zero TU."""
        if self.use_rdoq:
            from turingcodec_tpu_torch.cabac.engine import ctx_index
            from turingcodec_tpu_torch.encode.rdoq import rdoq_quantize
            levels = rdoq_quantize(
                coeffs, qp, bd, log2, c_idx,
                self._scan_for(log2, c_idx, mode, intra),
                ctx_index(cbf[0]) + cbf[1], self.rd_ctx.states, self.lam)
        else:
            levels = quantize_np(coeffs, qp, bd, log2, self.sh.is_i)
        if self.pps.sign_data_hiding_enabled_flag and levels.any():
            levels = apply_sdh(levels, coeffs, qp, bd, log2,
                               self._scan_for(log2, c_idx, mode, intra))
        return levels

    # ------------------------------------------------------------------
    def _scan_for(self, log2: int, c_idx: int, mode: int, intra: bool) -> int:
        if intra and (log2 == 2 or (log2 == 3 and c_idx == 0)):
            if 6 <= mode <= 14:
                return 2
            if 22 <= mode <= 30:
                return 1
        return 0

    def _residual_bits(self, levels: np.ndarray, log2: int, c_idx: int,
                       mode: int, intra: bool) -> float:
        """Exact CABAC fractional bits for this block given current ctx."""
        if not levels.any():
            return 1.0  # cbf bin
        from turingcodec_tpu_torch import native
        scan = self._scan_for(log2, c_idx, mode, intra)
        sdh = bool(self.pps.sign_data_hiding_enabled_flag)
        bits = native.residual_bits(self.rd_ctx.copy(), log2, c_idx, scan,
                                    sdh, levels)
        if bits is not None:
            return bits + 1.0  # + cbf bin
        from turingcodec_tpu_torch.cabac.rate import RateEstimator
        from turingcodec_tpu_torch.encode.ctu_write import residual_core
        est = RateEstimator(self.rd_ctx.copy())
        residual_core(est, levels, log2, c_idx, scan, sdh)
        return est.bits + 1.0  # + cbf bin

    def _commit_residual_ctx(self, levels, log2, c_idx, mode, intra):
        """Apply the chosen block's context transitions to the search pool
        (keeps rd_ctx in lockstep with the real writer)."""
        if not levels.any():
            return
        from turingcodec_tpu_torch import native
        scan = self._scan_for(log2, c_idx, mode, intra)
        if native.residual_bits(self.rd_ctx, log2, c_idx, scan,
                                bool(self.pps.sign_data_hiding_enabled_flag),
                                levels) is not None:
            return
        from turingcodec_tpu_torch.cabac.rate import RateEstimator
        from turingcodec_tpu_torch.encode.ctu_write import residual_core
        est = RateEstimator(self.rd_ctx)
        residual_core(est, levels, log2, c_idx, scan, False)

    @staticmethod
    def _coeff_rate(levels: np.ndarray) -> float:
        """Cheap rate proxy in bits (used where exact rate is overkill)."""
        a = np.abs(levels)
        nz = a > 0
        if not nz.any():
            return 1.0
        bits = 1.5 * nz.sum() + np.sum(2 * np.log2(a[nz] + 1)) + 8
        return float(bits)
