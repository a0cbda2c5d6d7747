"""Motion vector derivation: merge candidate list, AMVP, TMVP (spec 8.5.3).

Runs during parse (host) — motion derivation is pixel-independent. Reads
neighbour motion from the plan tensors being filled (the tensor analogue of
the reference's Snake neighbour storage, turing/Mvp.h:488-699).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from turingcodec_tpu_torch.hevc import types as T


def clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


def mv_scale(mv, tb, td):
    """Spec 8.5.3.1.8 temporal/spatial MV scaling."""
    tb = clip3(-128, 127, tb)
    td = clip3(-128, 127, td)
    tx = (16384 + (abs(td) >> 1)) // td if td >= 0 else -(
        (16384 + (abs(td) >> 1)) // -td)
    dist_scale = clip3(-4096, 4095, (tb * tx + 32) >> 6)
    out = []
    for c in mv:
        v = dist_scale * c
        v = clip3(-32768, 32767, (abs(v) + 127) >> 8 if v >= 0
                  else -((abs(v) + 127) >> 8))
        out.append(v)
    return tuple(out)


@dataclass
class MotionCand:
    pred_flags: tuple = (0, 0)
    mv: tuple = ((0, 0), (0, 0))
    ref_idx: tuple = (-1, -1)

    def motion_equal(self, other) -> bool:
        return (self.pred_flags == other.pred_flags
                and self.mv == other.mv and self.ref_idx == other.ref_idx)


class InterDeriver:
    """Per-slice context for motion derivation + plan fill (the inter_hook)."""

    def __init__(self, plan, geom, sh, dpb, cur_poc):
        self.plan = plan
        self.geom = geom
        self.sh = sh
        self.sps = plan.sps
        self.pps = plan.pps
        self.dpb = dpb
        self.cur_poc = cur_poc
        self.ref_lists = dpb.ref_pic_list
        self.ref_pocs = [[p.poc for p in lst] for lst in self.ref_lists]
        self.ref_lt = [[p.is_long_term for p in lst] for lst in self.ref_lists]
        self.no_backward = all(
            p.poc <= cur_poc for lst in self.ref_lists for p in lst)
        if sh.slice_temporal_mvp_enabled_flag and self.ref_lists[
                0 if sh.collocated_from_l0_flag else 1]:
            self.col_pic = self.ref_lists[
                0 if sh.collocated_from_l0_flag else 1][sh.collocated_ref_idx]
        else:
            self.col_pic = None

    # ---- neighbour access ------------------------------------------------
    def _nb_motion(self, x_cur, y_cur, x_nb, y_nb,
                   cb=None) -> Optional[MotionCand]:
        """Motion of the min-block at (x_nb, y_nb) per prediction-block
        availability (spec 6.4.2). cb = (x_cb, y_cb, n_cbs, n_pbw, n_pbh,
        part_idx) enables the same-CB rule: PUs earlier in the same CB are
        available regardless of z-scan order; the second-PU region is not.
        """
        plan = self.plan
        same_cb = False
        if cb is not None:
            x_cb, y_cb, n_cbs, n_pbw, n_pbh, part_idx = cb
            same_cb = (x_cb <= x_nb < x_cb + n_cbs
                       and y_cb <= y_nb < y_cb + n_cbs)
        if same_cb:
            if ((n_pbw << 1) == n_cbs and (n_pbh << 1) == n_cbs
                    and part_idx == 1
                    and (y_cb + n_pbh <= y_nb or x_cb + n_pbw <= x_nb)):
                return None
        elif not self.geom.available(plan.slice_idx, x_cur, y_cur, x_nb, y_nb):
            return None
        bx, by = x_nb >> 2, y_nb >> 2
        if plan.cu_pred_mode[by, bx] == 1:  # intra
            return None
        r0 = int(plan.ref_idx[0, by, bx])
        r1 = int(plan.ref_idx[1, by, bx])
        mv = plan.mv
        return MotionCand(
            pred_flags=(int(r0 >= 0), int(r1 >= 0)),
            mv=((int(mv[0, by, bx, 0]), int(mv[0, by, bx, 1])),
                (int(mv[1, by, bx, 0]), int(mv[1, by, bx, 1]))),
            ref_idx=(r0, r1))

    def _same_merge_region(self, x0, y0, xn, yn) -> bool:
        p = self.pps.log2_parallel_merge_level_minus2 + 2
        return (x0 >> p) == (xn >> p) and (y0 >> p) == (yn >> p)

    # ---- TMVP ------------------------------------------------------------
    def _col_mv(self, x_col, y_col, target_list, target_ref_idx):
        """Spec 8.5.3.1.8: collocated motion vector."""
        col = self.col_pic
        if col is None or col.plan is None:
            return None
        cplan = col.plan
        bx, by = (x_col >> 4) << 2, (y_col >> 4) << 2  # 16x16-aligned, /4
        if by >= cplan.ct_depth.shape[0] or bx >= cplan.ct_depth.shape[1]:
            return None
        if cplan.cu_pred_mode[by, bx] == 1:
            return None
        f0 = int(cplan.ref_idx[0, by, bx]) >= 0
        f1 = int(cplan.ref_idx[1, by, bx]) >= 0
        if not f0 and not f1:
            return None
        if not f0:
            n = 1
        elif not f1:
            n = 0
        elif self.no_backward:
            n = target_list
        else:
            n = self.sh.collocated_from_l0_flag
        mv_col = tuple(int(v) for v in cplan.mv[n, by, bx])
        col_ref_poc = int(cplan.ref_poc[n, by, bx])
        col_ref_lt = bool(cplan.ref_is_lt[n, by, bx])
        target_lt = self.ref_lt[target_list][target_ref_idx]
        if col_ref_lt != target_lt:
            return None
        curr_diff = self.cur_poc - self.ref_pocs[target_list][target_ref_idx]
        col_diff = col.poc - col_ref_poc
        if target_lt or col_diff == curr_diff:
            return mv_col
        if col_diff == 0:
            return mv_col
        return mv_scale(mv_col, curr_diff, col_diff)

    def _tmvp(self, x_pb, y_pb, w, h, target_list, target_ref_idx):
        """Temporal candidate: bottom-right then centre (spec 8.5.3.1.7)."""
        if not self.sh.slice_temporal_mvp_enabled_flag or self.col_pic is None:
            return None
        sps = self.sps
        x_br, y_br = x_pb + w, y_pb + h
        if ((y_pb >> sps.ctb_log2_size_y) == (y_br >> sps.ctb_log2_size_y)
                and y_br < sps.pic_height_in_luma_samples
                and x_br < sps.pic_width_in_luma_samples):
            mv = self._col_mv(x_br, y_br, target_list, target_ref_idx)
            if mv is not None:
                return mv
        x_c, y_c = x_pb + (w >> 1), y_pb + (h >> 1)
        return self._col_mv(x_c, y_c, target_list, target_ref_idx)

    # ---- merge -----------------------------------------------------------
    def merge_candidates(self, x_cb, y_cb, cb_size, x_pb, y_pb, w, h,
                         part_idx, part_mode,
                         max_needed=None) -> List[MotionCand]:
        """Merge candidate list (spec 8.5.3.1.2). With max_needed the
        derivation stops as soon as that many candidates exist — candidates
        are order-stable, so the decoder only derives up to merge_idx+1
        (the common merge_idx==0 case skips TMVP entirely)."""
        sh = self.sh
        need = sh.max_num_merge_cand
        if max_needed is not None and max_needed < need:
            need = max_needed
        plevel = self.pps.log2_parallel_merge_level_minus2 + 2
        if plevel > 2 and cb_size == 8:
            # all PUs of the 8x8 CU share the 2Nx2N merge list
            x_pb, y_pb, w, h, part_idx = x_cb, y_cb, cb_size, cb_size, 0

        cands: List[MotionCand] = []
        cb = (x_cb, y_cb, cb_size, w, h, part_idx)

        def neighbour(x_nb, y_nb, exclude):
            """Raw neighbour motion (None if excluded/unavailable/intra).

            Kept separately from list insertion: B0/A0/B2 prune against the
            B1/A1 *neighbour motion* even when that neighbour itself was
            pruned from the list (spec 8.5.3.1.2; reference Mvp.h puDataA1/
            puDataB1 usage).
            """
            if exclude:
                return None
            if self._same_merge_region(x_pb, y_pb, x_nb, y_nb):
                return None
            return self._nb_motion(x_pb, y_pb, x_nb, y_nb, cb)

        a1_m = neighbour(x_pb - 1, y_pb + h - 1,
                         part_idx == 1 and part_mode in
                         (T.PART_Nx2N, T.PART_nLx2N, T.PART_nRx2N))
        if a1_m:
            cands.append(a1_m)
            if len(cands) >= need:
                return cands
        b1_m = neighbour(x_pb + w - 1, y_pb - 1,
                         part_idx == 1 and part_mode in
                         (T.PART_2NxN, T.PART_2NxnU, T.PART_2NxnD))
        if b1_m and not (a1_m and b1_m.motion_equal(a1_m)):
            cands.append(b1_m)
            if len(cands) >= need:
                return cands
        b0_m = neighbour(x_pb + w, y_pb - 1, False)
        if b0_m and not (b1_m and b0_m.motion_equal(b1_m)):
            cands.append(b0_m)
            if len(cands) >= need:
                return cands
        a0_m = neighbour(x_pb - 1, y_pb + h, False)
        if a0_m and not (a1_m and a0_m.motion_equal(a1_m)):
            cands.append(a0_m)
            if len(cands) >= need:
                return cands
        if len(cands) < 4:
            b2_m = neighbour(x_pb - 1, y_pb - 1, False)
            if b2_m and not (a1_m and b2_m.motion_equal(a1_m)) \
                    and not (b1_m and b2_m.motion_equal(b1_m)):
                cands.append(b2_m)
                if len(cands) >= need:
                    return cands

        max_cand = need
        # temporal
        if len(cands) < max_cand:
            mv0 = self._tmvp(x_pb, y_pb, w, h, 0, 0)
            if sh.is_b:
                mv1 = self._tmvp(x_pb, y_pb, w, h, 1, 0)
            else:
                mv1 = None
            if mv0 is not None or mv1 is not None:
                cands.append(MotionCand(
                    pred_flags=(int(mv0 is not None), int(mv1 is not None)),
                    mv=(mv0 or (0, 0), mv1 or (0, 0)),
                    ref_idx=(0 if mv0 is not None else -1,
                             0 if mv1 is not None else -1)))

        # combined bi-predictive (B slices)
        if sh.is_b and len(cands) > 1 and len(cands) < max_cand:
            comb = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                    (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2)]
            n_orig = len(cands)
            for (k, l) in comb:
                if len(cands) >= max_cand:
                    break
                if k >= n_orig or l >= n_orig:
                    break
                c0, c1 = cands[k], cands[l]
                if not (c0.pred_flags[0] and c1.pred_flags[1]):
                    continue
                poc0 = self.ref_pocs[0][c0.ref_idx[0]]
                poc1 = self.ref_pocs[1][c1.ref_idx[1]]
                if poc0 == poc1 and c0.mv[0] == c1.mv[1]:
                    continue
                cands.append(MotionCand(
                    pred_flags=(1, 1), mv=(c0.mv[0], c1.mv[1]),
                    ref_idx=(c0.ref_idx[0], c1.ref_idx[1])))

        # zero candidates
        num_ref = (min(len(self.ref_lists[0]), len(self.ref_lists[1]))
                   if sh.is_b else len(self.ref_lists[0]))
        zero_idx = 0
        while len(cands) < max_cand:
            r = zero_idx if zero_idx < num_ref else 0
            if sh.is_b:
                cands.append(MotionCand((1, 1), ((0, 0), (0, 0)), (r, r)))
            else:
                cands.append(MotionCand((1, 0), ((0, 0), (0, 0)), (r, -1)))
            zero_idx += 1
        return cands

    # ---- AMVP ------------------------------------------------------------
    def amvp(self, x_pb, y_pb, w, h, lx, ref_idx, cb=None) -> List[tuple]:
        """Two MVP candidates for list lx / ref_idx (spec 8.5.3.1.5/6)."""
        target_poc = self.ref_pocs[lx][ref_idx]
        target_lt = self.ref_lt[lx][ref_idx]

        def try_same(m: Optional[MotionCand]):
            """Pass 1: neighbour uses the same reference picture."""
            if m is None:
                return None
            for l in (lx, 1 - lx):
                if m.pred_flags[l]:
                    r = m.ref_idx[l]
                    if r < len(self.ref_pocs[l]) and \
                            self.ref_pocs[l][r] == target_poc and \
                            self.ref_lt[l][r] == target_lt:
                        return m.mv[l]
            return None

        def try_scaled(m: Optional[MotionCand]):
            """Pass 2: any reference, scaled (short-term only)."""
            if m is None:
                return None
            for l in (lx, 1 - lx):
                if m.pred_flags[l]:
                    r = m.ref_idx[l]
                    if r >= len(self.ref_pocs[l]):
                        continue
                    nb_lt = self.ref_lt[l][r]
                    if nb_lt != target_lt:
                        continue
                    nb_poc = self.ref_pocs[l][r]
                    if target_lt:
                        return m.mv[l]
                    tb = self.cur_poc - target_poc
                    td = self.cur_poc - nb_poc
                    if td == tb:
                        return m.mv[l]
                    if td == 0:
                        return m.mv[l]
                    return mv_scale(m.mv[l], tb, td)
            return None

        a0 = self._nb_motion(x_pb, y_pb, x_pb - 1, y_pb + h, cb)
        a1 = self._nb_motion(x_pb, y_pb, x_pb - 1, y_pb + h - 1, cb)
        avail_a_any = a0 is not None or a1 is not None
        mv_a = None
        for m in (a0, a1):
            mv_a = try_same(m)
            if mv_a is not None:
                break
        if mv_a is None:
            for m in (a0, a1):
                mv_a = try_scaled(m)
                if mv_a is not None:
                    break

        b0 = self._nb_motion(x_pb, y_pb, x_pb + w, y_pb - 1, cb)
        b1 = self._nb_motion(x_pb, y_pb, x_pb + w - 1, y_pb - 1, cb)
        b2 = self._nb_motion(x_pb, y_pb, x_pb - 1, y_pb - 1, cb)
        mv_b = None
        for m in (b0, b1, b2):
            mv_b = try_same(m)
            if mv_b is not None:
                break
        if not avail_a_any:
            # scaled B pass only when no A neighbour exists at all
            if mv_b is not None:
                mv_a = mv_b
                mv_b = None
            for m in (b0, b1, b2):
                nb = try_scaled(m)
                if nb is not None:
                    if mv_a is None:
                        mv_a = nb
                    elif nb != mv_a and mv_b is None:
                        mv_b = nb
                    break

        cands = []
        if mv_a is not None:
            cands.append(mv_a)
        if mv_b is not None and (not cands or mv_b != cands[0]):
            cands.append(mv_b)
        if len(cands) < 2:
            tmv = self._tmvp(x_pb, y_pb, w, h, lx, ref_idx)
            if tmv is not None:
                cands.append(tmv)
        while len(cands) < 2:
            cands.append((0, 0))
        return cands[:2]

    # ---- the hook --------------------------------------------------------
    def __call__(self, ps, x0, y0, w, h, part_idx, n_parts, pu_syntax):
        plan, sh = self.plan, self.sh
        cu = ps.cu
        if pu_syntax["merge"]:
            cands = self.merge_candidates(
                cu.x0, cu.y0, 1 << cu.log2_size, x0, y0, w, h,
                part_idx, cu.part_mode,
                max_needed=pu_syntax["merge_idx"] + 1)
            c = cands[pu_syntax["merge_idx"]]
            pred_flags = list(c.pred_flags)
            mv = [list(c.mv[0]), list(c.mv[1])]
            ref_idx = list(c.ref_idx)
            if w + h == 12 and pred_flags[0] and pred_flags[1]:
                pred_flags[1] = 0
                ref_idx[1] = -1
        else:
            ipi = pu_syntax["inter_pred_idc"]
            pred_flags = [int(bool(ipi & 1)), int(bool(ipi & 2))]
            mv = [[0, 0], [0, 0]]
            ref_idx = [-1, -1]
            cb = (cu.x0, cu.y0, 1 << cu.log2_size, w, h, part_idx)
            for l in (0, 1):
                if not pred_flags[l]:
                    continue
                r = pu_syntax["ref_idx"][l]
                ref_idx[l] = r
                mvps = self.amvp(x0, y0, w, h, l, r, cb)
                mvp = mvps[pu_syntax["mvp_flag"][l]]
                mvd = pu_syntax["mvd"][l]
                mv[l] = [clip3(-32768, 32767, mvp[0] + mvd[0]),
                         clip3(-32768, 32767, mvp[1] + mvd[1])]
        # write into plan
        ys, xs = slice(y0 >> 2, (y0 + h) >> 2), slice(x0 >> 2, (x0 + w) >> 2)
        for l in (0, 1):
            if pred_flags[l] and ref_idx[l] >= 0:
                plan.ref_idx[l, ys, xs] = ref_idx[l]
                plan.mv[l, ys, xs] = mv[l]
                plan.ref_poc[l, ys, xs] = self.ref_pocs[l][ref_idx[l]]
                plan.ref_is_lt[l, ys, xs] = int(self.ref_lt[l][ref_idx[l]])
            else:
                plan.ref_idx[l, ys, xs] = -1
                plan.mv[l, ys, xs] = 0
