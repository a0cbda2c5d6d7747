"""Inter picture encoding: motion estimation + merge/skip/AMVP decision,
built on top of the intra search (intra remains the fallback mode).

Parity reference: turing/Search.hpp fullPelMotionEstimation (2064),
subPelRefinement (2340), searchMerge2Nx2N (925) — recast as pattern search
with explicit candidate cost λ·SAD + rate(mvd) (same cost model).
Round-1 scope: P slices, 2Nx2N PUs, one reference.
"""
from __future__ import annotations

import math
import os
from typing import List

import numpy as np

from turingcodec_tpu_torch.hevc import types as T
from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
from turingcodec_tpu_torch.decode.inter_pred import interp_chroma, interp_luma
from turingcodec_tpu_torch.decode.mvp import InterDeriver, MotionCand
from turingcodec_tpu_torch.decode.reconstruct import dequant_block, inverse_transform
from turingcodec_tpu_torch.encode.intra_search import (
    IntraPictureEncoder,
    quantize_np,
)
from turingcodec_tpu_torch.ops.transform import forward_transform_np


def _mv_bits(mvd_x: int, mvd_y: int) -> float:
    """Approximate mvd rate in bits (EG1-ish)."""
    def b(v):
        a = abs(v)
        if a == 0:
            return 1.0
        return 3.0 + 2.0 * math.floor(math.log2(a + 1))
    return b(mvd_x) + b(mvd_y)


class _DpbView:
    """Adapter: the InterDeriver expects a dpb with ref_pic_list."""

    def __init__(self, ref_lists):
        self.ref_pic_list = ref_lists


class InterPictureEncoder(IntraPictureEncoder):
    def __init__(self, sps, pps, sh, geom, ref_lists, cur_poc,
                 rd_candidates=2, max_cu_log2=5, search_range=48,
                 use_rdoq=False):
        super().__init__(sps, pps, sh, geom, rd_candidates, max_cu_log2,
                         use_rdoq)
        self.max_cu_inter_log2 = sps.ctb_log2_size_y
        self.ref_lists = ref_lists
        self.cur_poc = cur_poc
        self.search_range = search_range
        from turingcodec_tpu_torch.decode.inter_pred import derive_wp_tables
        self.wp = derive_wp_tables(sh, sps)  # explicit weighted prediction
        # HM P-frame lambda
        self.lam = 0.85 * (2.0 ** ((self.qp - 12) / 3.0))
        self.lam_bits = self.lam
        self.lam_me = math.sqrt(self.lam)
        # Speed.h useMet / useFdm+useFdam analogues (set by the Encoder
        # facade per preset; default off so direct construction keeps the
        # exhaustive search)
        self.met = False
        self.fdam = False
        self.esd = False
        self.aps = False
        self._aps_quad = None  # 2Nx2N champion's per-quadrant |residual|
        # lowres pre-ME seed fields, one per reference plane (native
        # lowres_prepass twin; keyed by plane identity)
        self._lr_seed_cache = {}
        # dense full-res +/-8 ME fields (native dense_prepass twin)
        self._dense_cache = {}
        # torch device of the analysis stage (set by the Encoder facade
        # from EncoderConfig.device; None = host path)
        self.device = None

    # dense-SAD median above this -> the picture is motion-unpredictable
    # (noise-dominated): 3 SAD/pixel over a 16x16 block. Measured medians:
    # caminandes 12-134, 3x-upscaled 1080p 62, white-noise synthetic 1506.
    NOISE_SAD_MEDIAN = 768

    def encode_picture(self, orig, slice_number=0):
        self.deriver = None  # created lazily (needs plan)
        if not getattr(self, "_noise_done", False):
            self.prepare_analysis(orig)
        return super().encode_picture(orig, slice_number)

    def prepare_analysis(self, orig):
        """Per-picture pre-analysis, callable ahead of encode_picture so
        the frame-parallel facade can run it in the sequential prepare
        phase: with an analysis device (EncoderConfig.device) the lowres
        pre-ME + dense ME fields and the subpel planes run there
        (bit-identical values feed the host RDO), and the noise-adaptive
        RDOQ decision consumes the dense SAD field."""
        self._device_seeds = None
        self._device_subpel = None
        if self.device is not None and not getattr(self, "_overlap", False):
            from turingcodec_tpu_torch.encode.device_analysis import (
                device_enc_enabled, install_seed_fields,
                install_subpel_fields)
            if device_enc_enabled(self.device):
                # overlap: reference reconstructions are in flight — the
                # source-referenced fields from _noise_adapt stand in
                self._device_seeds = install_seed_fields(self, orig)
                self._device_subpel = install_subpel_fields(self)
        self._noise_adapt(orig)
        self._noise_done = True

    def _noise_adapt(self, orig):
        """Noise-adaptive RDOQ: when the dense ME field says the picture
        is temporally unpredictable (median winner SAD > NOISE_SAD_MEDIAN),
        RD-optimal level-1 retention pollutes the reference chain — every
        kept noise coefficient raises all future residuals — so fall back
        to dead-zone quantization for this picture. Closes the
        white-noise BD gap (+8% -> ~0) while keeping RDOQ's 5-7% win on
        natural content. The decision uses the same integer SAD field in
        the native / Python / device paths, so bitstreams stay identical
        across them."""
        if not self.use_rdoq or self.sh.is_i or self.search_range < 16:
            return
        if not self.met:
            # MET presets (fast/medium) only: at slow the reference runs
            # RDOQ too, and matching its operating point measured ~0.5%
            # better BD on noise than the dead-zone fallback
            return
        if os.environ.get("TC_NO_NOISE_ADAPT") \
                or os.environ.get("TC_NO_DENSEME") \
                or os.environ.get("TC_NO_LOWRES"):
            return
        # _seed_src (facade, TC_SRC_SEEDS): analyse against the reference
        # picture's SOURCE plane instead of its reconstruction — the
        # x264-lookahead structure. Seeds/noise stats then depend only on
        # input pictures, so the analysis of a whole GOP can run before
        # (or concurrent with) any encode: the enabler for GOP-batched
        # device analysis and dependent-picture overlap.
        ss = getattr(self, "_seed_src", None) or {}

        def seed_plane(lx):
            r2 = self.ref_lists[lx] if lx < len(self.ref_lists) else []
            if not r2:
                return None
            sp = ss.get(lx)
            if sp is None and getattr(self, "_overlap", False):
                # overlap: never touch an in-flight reconstruction here
                # (no stashed source for this ref -> no field, which is a
                # static function of the docket sequence: deterministic)
                return None
            return sp if sp is not None else r2[0].planes[0]

        plane0 = seed_plane(0)
        if plane0 is None:
            return
        from turingcodec_tpu_torch import native
        fields = {}
        have_native = True
        for lx in (0, 1):
            pl = seed_plane(lx)
            if pl is None:
                continue
            k = id(pl)
            if k not in self._dense_cache:
                res = native.dense_analysis(np.asarray(orig[0]),
                                            np.asarray(pl),
                                            self.sps.bit_depth_y)
                if res is None:
                    have_native = False
                    break
                sm, dm, ds, wb, hb = res[:5]
                surf = res[5] if len(res) > 5 else None
                self._lr_seed_cache[k] = (sm, wb, hb)
                self._dense_cache[k] = (dm, ds, wb, hb, surf)
            sm = self._lr_seed_cache[k][0]
            ce = self._dense_cache[k]
            dm, ds, wb, hb = ce[:4]
            surf = ce[4] if len(ce) > 4 else None
            # the SAD surface is only exact against the true recon ref
            # (source-referenced analysis fields install seeds only)
            if ss.get(lx) is not None:
                surf = None
            fields[lx] = (sm, dm, wb, hb, surf)
        if have_native:
            # feed the in-picture native prepass the same fields
            # (the install path the device stage already uses)
            if fields:
                prior = self._device_seeds or {}
                prior.update({lx: f for lx, f in fields.items()
                              if lx not in prior})
                self._device_seeds = prior
            dsad = self._dense_cache[id(plane0)][1]
        else:
            self.orig = orig  # _dense_field reads self.orig
            dsad = self._dense_field(plane0)[1]
        flat = np.sort(np.asarray(dsad), axis=None)
        hit = int(flat[flat.size // 2]) > self.NOISE_SAD_MEDIAN
        # persistence: noise is unpredictable EVERY frame; a lone
        # unpredictable picture is a scene cut whose coded detail future
        # frames need (caminandes' cut measured median 5551 and cost
        # ~1.3% BD when it flipped rdoq off)
        streak = getattr(self, "noise_streak", 0)
        if hit and streak >= 1:
            self.use_rdoq = False
        self.noise_streak = streak + 1 if hit else 0

    # ------------------------------------------------------------------
    def _get_deriver(self) -> InterDeriver:
        if self.deriver is None:
            self.deriver = InterDeriver(self.plan, self.geom, self.sh,
                                        _DpbView(self.ref_lists), self.cur_poc)
        return self.deriver

    # ------------------------------------------------------------------
    def _encode_cu(self, x0, y0, log2, depth) -> float:
        """Try inter (skip/merge/AMVP) and intra; commit the best."""
        if self.sh.is_i:
            return super()._encode_cu(x0, y0, log2, depth)
        size = 1 << log2
        state = self._snapshot(x0, y0, size)
        cost_best = self._encode_inter_cu(x0, y0, log2, depth)
        best_state = self._snapshot(x0, y0, size)
        # SMP/AMP partitions, Search<prediction_unit> analogue. Speed.h
        # useSmp: slow/medium search 2NxN/Nx2N at every size INCLUDING 8x8
        # (8x4/4x8 PUs give motion boundaries inside an 8x8 separate
        # vectors — worth ~1% BD at slow). Documented deviation: the
        # reference's fast searches SMP at 8x8 only; ours searches none at
        # fast — measured to cost ~30% encode speed for ~0 BD there (our
        # fast is already ahead of the reference's on BD). An ESD skip
        # champion ends the partition loop (the reference's esd break).
        if (self.rd_candidates >= 2 and log2 >= 3
                and not (getattr(self, "esd", False)
                         and self.plan.skip_flag[y0 >> 2, x0 >> 2])):
            # APS (Aps.h:45-85): gate 2NxN/Nx2N by the residue-energy
            # balance of the 2Nx2N champion's prediction quadrants
            do_2nxn = do_nx2n = True
            if getattr(self, "aps", False) and self._aps_quad is not None:
                q00, q01, q10, q11 = self._aps_quad
                half = size >> 1
                thr = 4 * half * half * 2
                num, den = q00 + q01, q10 + q11
                if num < thr and den < thr:
                    do_2nxn = False
                else:
                    delta = den >> 2
                    do_2nxn = not (den - delta < num < den + delta)
                num, den = q00 + q10, q01 + q11
                if num < thr and den < thr:
                    do_nx2n = False
                else:
                    delta = den >> 2
                    do_nx2n = not (den - delta < num < den + delta)
            parts = [T.PART_2NxN, T.PART_Nx2N]
            if (self.sps.amp_enabled_flag and self.rd_candidates >= 3
                    and log2 >= 4):
                parts += [T.PART_2NxnU, T.PART_2NxnD,
                          T.PART_nLx2N, T.PART_nRx2N]
            for part in parts:
                if getattr(self, "aps", False):
                    if part == T.PART_2NxN and not do_2nxn:
                        continue
                    if part == T.PART_Nx2N and not do_nx2n:
                        continue
                self._restore(x0, y0, size, state)
                c = self._encode_inter_smp(x0, y0, log2, depth, part)
                if c < cost_best:
                    cost_best = c
                    best_state = self._snapshot(x0, y0, size)
        # early skip: when the best inter choice is a skip CU (merge, no
        # residual), the intra trial essentially never wins — HM/reference
        # early-skip gating
        self._restore(x0, y0, size, best_state)
        if self.plan.skip_flag[y0 >> 2, x0 >> 2]:
            return cost_best
        # CFM (cbf fast mode, Speed.h cfm analogue; fast/medium presets):
        # an inter winner with no coded coefficients predicts well enough
        # that the intra trial is skipped
        if self.rd_candidates <= 2 and not (
                self.plan.cbf_y[y0 >> 2, x0 >> 2]
                or self.plan.cbf_cb[y0 >> 2, x0 >> 2]
                or self.plan.cbf_cr[y0 >> 2, x0 >> 2]):
            return cost_best
        if log2 > self.sps.max_tb_log2_size_y and (
                log2 != 6 or self.rd_candidates < 3
                or os.environ.get("TC_NO_I64")):
            # 64x64 intra (forced TU split) is trialed at slow only
            return cost_best
        self._restore(x0, y0, size, state)
        # intra trial: its cost includes its own cu_skip/pred_mode/part
        # mode bins exactly (committed inside _encode_cu), so the budget
        # is simply the inter champion's total cost
        cost_intra = (self._encode_cu64(x0, y0, depth)
                      if log2 > self.sps.max_tb_log2_size_y
                      else super()._encode_cu(x0, y0, log2, depth,
                                              budget=cost_best))
        if cost_best <= cost_intra:
            self._restore(x0, y0, size, best_state)
            return cost_best
        return cost_intra

    # ------------------------------------------------------------------
    def _cand_est_2nx2n(self, x0, y0, log2, depth, kind, idx, info,
                        lv_y, lv_cb, lv_cr, ts_cb=0, ts_cr=0,
                        split_tt=False):
        """Exact writer bins of one 2Nx2N inter CU candidate, chained on a
        copy of the live pool: cu_skip/pred_mode/part_mode, the PU's
        merge or AMVP bins, rqt_root_cbf, and the full transform tree
        (cbf + residual) — the writer's order bin for bin."""
        from turingcodec_tpu_torch.cabac.engine import ctx_index
        est = self._mb_est()
        has = bool(lv_y.any() or lv_cb.any() or lv_cr.any())
        if kind == "merge" and not has:
            # merge without residual is a skip CU
            self._emit_skip_cu(est, x0, y0, idx)
            return est
        self._emit_cu_skip(est, x0, y0, 0)
        est.encode_decision(ctx_index("pred_mode_flag"), 0)
        self._emit_inter_part_mode(est, T.PART_2Nx2N, log2)
        size = 1 << log2
        if kind == "merge":
            self._emit_merge_pu(est, idx)
        else:
            self._emit_amvp_pu(est, depth, size, size, info)
            est.encode_decision(ctx_index("rqt_root_cbf"), int(has))
        if has:
            if split_tt:
                self._emit_tt_split(est, log2, lv_y, lv_cb, lv_cr)
            else:
                self._emit_tt_single(est, log2, lv_y, lv_cb, lv_cr,
                                     ts_cb, ts_cr)
        return est

    def _snapshot(self, x0, y0, size):
        base = super()._snapshot(x0, y0, size)  # 5-tuple
        p = self.plan
        sl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
        extra = [p.skip_flag[sl].copy(), p.merge_flag[sl].copy(),
                 p.merge_idx[sl].copy(),
                 p.mv[(slice(None),) + sl].copy(),
                 p.ref_idx[(slice(None),) + sl].copy(),
                 p.ref_poc[(slice(None),) + sl].copy(),
                 p.mvd[(slice(None),) + sl].copy(),
                 p.mvp_flag[(slice(None),) + sl].copy()]
        return base + (extra,)

    def _restore(self, x0, y0, size, state):
        super()._restore(x0, y0, size, state[:5])
        p = self.plan
        sl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
        extra = state[5]
        (p.skip_flag[sl], p.merge_flag[sl], p.merge_idx[sl],
         p.mv[(slice(None),) + sl], p.ref_idx[(slice(None),) + sl],
         p.ref_poc[(slice(None),) + sl], p.mvd[(slice(None),) + sl],
         p.mvp_flag[(slice(None),) + sl]) = [a.copy() for a in extra]

    # ------------------------------------------------------------------
    def _mc14(self, ref_pic, mv, x0, y0, w, h):
        """14-bit intermediate prediction (luma + chroma)."""
        sps = self.sps
        mvx, mvy = int(mv[0]), int(mv[1])
        ry, rcb, rcr = ref_pic.planes
        py = interp_luma(ry, x0 + (mvx >> 2), y0 + (mvy >> 2), mvx & 3,
                         mvy & 3, w, h, self.bd)
        xc, yc = x0 >> 1, y0 >> 1
        pcb = interp_chroma(rcb, xc + (mvx >> 3), yc + (mvy >> 3), mvx & 7,
                            mvy & 7, w >> 1, h >> 1, sps.bit_depth_c)
        pcr = interp_chroma(rcr, xc + (mvx >> 3), yc + (mvy >> 3), mvx & 7,
                            mvy & 7, w >> 1, h >> 1, sps.bit_depth_c)
        return py, pcb, pcr

    def _finalize_pred(self, p14s):
        """Default or explicit weighted sample prediction (uni or bi) from
        14-bit parts. Matches decode.inter_pred.predict_pu exactly.

        With explicit WP configured (P slices, one shared L0 weight), every
        uni prediction here is L0 so entry 0's weight applies."""
        sps = self.sps
        if getattr(self, "wp", None) is not None:
            from turingcodec_tpu_torch.decode.inter_pred import weighted_combine
            wp = self.wp
            out = []
            for ci, bd in ((0, self.bd), (1, sps.bit_depth_c),
                           (2, sps.bit_depth_c)):
                ps = [p[ci] for p in p14s if p is not None]
                assert len(ps) == 1, "encoder WP supports uni-pred (P) only"
                e = wp[0][0]
                wo = (e["wy"], e["oy"]) if ci == 0 else \
                    (e["wc"][ci - 1], e["oc"][ci - 1])
                log2d = wp["log2d_y"] if ci == 0 else wp["log2d_c"]
                out.append(weighted_combine(ps[0], None, bd, log2d, wo, None))
            return out
        out = []
        for ci, bd in ((0, self.bd), (1, sps.bit_depth_c),
                       (2, sps.bit_depth_c)):
            shift = 14 - bd
            ps = [p[ci] for p in p14s if p is not None]
            if len(ps) == 2:
                v = (ps[0].astype(np.int64) + ps[1] + (1 << shift)) \
                    >> (shift + 1)
            else:
                v = (ps[0] + (1 << (shift - 1))) >> shift
            out.append(np.clip(v, 0, (1 << bd) - 1).astype(np.int32))
        return out

    def _mc(self, ref_pic, mv, x0, y0, w, h):
        """Uni-directional motion compensation (final clipped samples)."""
        return self._finalize_pred([self._mc14(ref_pic, mv, x0, y0, w, h)])

    def _pred_for_motion(self, pred_flags, mvs, ref_idxs, x0, y0, w, h):
        p14s = []
        for lx in (0, 1):
            if pred_flags[lx]:
                ref = self.ref_lists[lx][ref_idxs[lx]]
                p14s.append(self._mc14(ref, mvs[lx], x0, y0, w, h))
            else:
                p14s.append(None)
        return self._finalize_pred(p14s)

    def _pred_luma_for_motion(self, pred_flags, mvs, ref_idxs, x0, y0, w, h):
        """Luma-only finalized prediction for SATD candidate ranking."""
        p14s = []
        for lx in (0, 1):
            if pred_flags[lx]:
                ref = self.ref_lists[lx][ref_idxs[lx]]
                mvx, mvy = int(mvs[lx][0]), int(mvs[lx][1])
                py = interp_luma(ref.planes[0], x0 + (mvx >> 2),
                                 y0 + (mvy >> 2), mvx & 3, mvy & 3, w, h,
                                 self.bd)
                p14s.append((py,))
            else:
                p14s.append(None)
        bd = self.bd
        if getattr(self, "wp", None) is not None:
            from turingcodec_tpu_torch.decode.inter_pred import weighted_combine
            wp = self.wp
            ps = [p[0] for p in p14s if p is not None]
            e = wp[0][0]
            return weighted_combine(ps[0], None, bd, wp["log2d_y"],
                                    (e["wy"], e["oy"]), None)
        shift = 14 - bd
        ps = [p[0] for p in p14s if p is not None]
        if len(ps) == 2:
            v = (ps[0].astype(np.int64) + ps[1] + (1 << shift)) >> (shift + 1)
        else:
            v = (ps[0] + (1 << (shift - 1))) >> shift
        return np.clip(v, 0, (1 << bd) - 1).astype(np.int32)

    # ------------------------------------------------------------------
    @staticmethod
    def _lowres_plane(src, f, b, wb, hb, border):
        """Factor-f decimation with clamped edges, padded by replication to
        (hb*b + 2*border, wb*b + 2*border) — enc_core.cpp lowres_plane<f,b>
        twin (identical integer rounding)."""
        h, w = src.shape
        lw, lh = -(-w // f), -(-h // f)
        p = np.pad(src.astype(np.int32), ((0, lh * f - h), (0, lw * f - w)),
                   "edge")
        lr = (p.reshape(lh, f, lw, f).sum((1, 3)) + f * f // 2) // (f * f)
        lr = np.pad(lr, ((0, hb * b - lh), (0, wb * b - lw)), "edge")
        return np.pad(lr, border, "edge")

    def _lowres_seed_field(self, ref_plane):
        """Quarter-res exhaustive +/-8 pre-ME per 16x16 block, refined +/-2
        at half res — the Python oracle of enc_core.cpp lowres_prepass
        (identical costs (sad<<2)+|dx|+|dy| and scan-order tie-breaks).
        Returns (seed_mv (hb, wb, 2) int full-pel, wb, hb)."""
        key = id(ref_plane)
        cached = self._lr_seed_cache.get(key)
        if cached is not None:
            return cached
        orig = np.asarray(self.orig[0])
        h, w = orig.shape
        lw, lh = -(-w // 4), -(-h // 4)
        wb, hb = -(-lw // 4), -(-lh // 4)
        cur4 = self._lowres_plane(orig, 4, 4, wb, hb, 0)
        ref4 = self._lowres_plane(np.asarray(ref_plane), 4, 4, wb, hb, 8)
        costs = np.empty((17 * 17, hb, wb), np.int64)
        for i, (dy, dx) in enumerate((dy, dx) for dy in range(-8, 9)
                                     for dx in range(-8, 9)):
            d = np.abs(cur4 - ref4[8 + dy:8 + dy + hb * 4,
                                   8 + dx:8 + dx + wb * 4])
            costs[i] = (d.reshape(hb, 4, wb, 4).sum((1, 3)) << 2) \
                + abs(dx) + abs(dy)
        idx = costs.reshape(17 * 17, -1).argmin(0).reshape(hb, wb)
        sdx, sdy = idx % 17 - 8, idx // 17 - 8
        # half-res +/-2 refinement to 2-pel granularity
        cur8 = self._lowres_plane(orig, 2, 8, wb, hb, 0)
        ref8 = self._lowres_plane(np.asarray(ref_plane), 2, 8, wb, hb, 24)
        cb = cur8.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
        by, bx = np.mgrid[0:hb, 0:wb]
        chy, chx = 2 * sdy, 2 * sdx  # (4*d) >> 1
        ay = np.arange(8)
        best_c = None
        bsx = (4 * sdx).astype(np.int64)
        bsy = (4 * sdy).astype(np.int64)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                ys = (by * 8 + chy + dy + 24)[:, :, None, None] \
                    + ay[None, None, :, None]
                xs = (bx * 8 + chx + dx + 24)[:, :, None, None] \
                    + ay[None, None, None, :]
                sad = np.abs(cb - ref8[ys, xs]).sum((2, 3))
                sx, sy = 2 * (chx + dx), 2 * (chy + dy)
                c = (sad.astype(np.int64) << 2) + np.abs(sx) + np.abs(sy)
                if best_c is None:
                    best_c, bsx, bsy = c, sx.copy(), sy.copy()
                else:
                    m = c < best_c
                    best_c = np.where(m, c, best_c)
                    bsx = np.where(m, sx, bsx)
                    bsy = np.where(m, sy, bsy)
        field = (np.stack([bsx, bsy], -1).astype(np.int32), wb, hb)
        self._lr_seed_cache[key] = field
        return field

    def _dense_field(self, ref_plane):
        """Dense full-res ME field: per 16x16 block, the exhaustive +/-8
        full-pel SAD winner around the lowres seed, over edge-replicated
        padded planes. cost = (SAD << 2) + |ox| + |oy|, scan-order (oy, ox
        ascending) strict-improvement tie-break — the Python oracle of
        enc_core.cpp dense_prepass (and of the XLA/Pallas device twins in
        device_analysis). This whole-picture batched sweep replaces the
        star search's wide scanning; it is the encoder's ME hot loop
        (ref:turing/Search.hpp:1464-1483's role) recast as one dense
        tensor program. Returns (mv (hb, wb, 2) int full-pel,
        sad (hb, wb) int32 winner SADs, wb, hb) — the SADs double as the
        per-picture temporal-unpredictability map (noise-adaptive RDOQ)."""
        key = id(ref_plane)
        cached = self._dense_cache.get(key)
        if cached is not None:
            return cached[:4]
        sm, wb, hb = self._lowres_seed_field(ref_plane)
        orig = np.asarray(self.orig[0])
        h, w = orig.shape
        P = 48
        cur = np.pad(orig.astype(np.int32),
                     ((0, hb * 16 - h), (0, wb * 16 - w)), "edge")
        ref = np.pad(np.asarray(ref_plane).astype(np.int32),
                     ((0, hb * 16 - h), (0, wb * 16 - w)), "edge")
        ref = np.pad(ref, P, "edge")
        cb = cur.reshape(hb, 16, wb, 16).transpose(0, 2, 1, 3)
        by, bx = np.mgrid[0:hb, 0:wb]
        a32 = np.arange(32)
        ys = (by * 16 + sm[:, :, 1] - 8 + P)[:, :, None, None] \
            + a32[None, None, :, None]
        xs = (bx * 16 + sm[:, :, 0] - 8 + P)[:, :, None, None] \
            + a32[None, None, None, :]
        patch = ref[ys, xs]  # (hb, wb, 32, 32)
        best = bsad = None
        box = boy = None
        for oy in range(17):
            for ox in range(17):
                sad = np.abs(cb - patch[:, :, oy:oy + 16,
                                        ox:ox + 16]).sum((2, 3))
                cost = (sad.astype(np.int64) << 2) \
                    + abs(ox - 8) + abs(oy - 8)
                if best is None:
                    best = cost
                    bsad = sad.copy()
                    box = np.full((hb, wb), ox)
                    boy = np.full((hb, wb), oy)
                else:
                    m = cost < best
                    best = np.where(m, cost, best)
                    bsad = np.where(m, sad, bsad)
                    box = np.where(m, ox, box)
                    boy = np.where(m, oy, boy)
        field = (np.stack([sm[:, :, 0] + box - 8,
                           sm[:, :, 1] + boy - 8], -1).astype(np.int32),
                 bsad.astype(np.int32), wb, hb)
        self._dense_cache[key] = field
        return field

    def _full_pel_search(self, orig, ref_plane, x0, y0, w, h, mvp,
                         seeds=()):
        """Diamond/step pattern integer search; returns best int MV (in
        full-pel units) minimizing SAD + lam_me * mvd bits.

        seeds: extra quarter-pel MV hints (second MVP, merge candidates) —
        the reference seeds its pattern search the same way
        (Search.hpp:2064: zero, both MVPs, previous best)."""
        from turingcodec_tpu_torch.encode.sweep import sad_many
        seen = {}

        def costs_at(cands):
            """Batched SAD + lambda*mvd-bits for a list of (ix, iy)."""
            fresh = [c for c in cands if c not in seen]
            if fresh:
                xs = np.array([x0 + ix for ix, _ in fresh])
                ys = np.array([y0 + iy for _, iy in fresh])
                sads = sad_many(orig, ref_plane, xs, ys, w, h)
                for (ix, iy), s in zip(fresh, sads):
                    seen[(ix, iy)] = float(s) + self.lam_me * _mv_bits(
                        4 * ix - mvp[0], 4 * iy - mvp[1])
            return [(seen[c], c) for c in cands]

        # seed 0: zero MV (further seeds are evaluated below, after the
        # pattern helpers, so MET probes can interleave with them exactly
        # as in the reference and the native twin)
        best = costs_at([(0, 0)])[0]
        # probes are bounded only by the native cache radius; search_range
        # selects the star window / raster extent (the reference's
        # searchWindow caps one pass's distances around the chained center,
        # not the absolute MV range)
        sr = 128

        # HM-style star search (Search.hpp:2202-2301 fullPelMotionEstimation,
        # native twin full_pel_search): 16-point diamond at doubling
        # distances around a fixed center, raster fallback when the winning
        # distance was large, star refinement until converged. Patterns are
        # in a quarter-pel basis; (entry*dist) >> 2 is integer for the
        # (step, dist) pairs used.
        star16 = ((0, -4), (1, -3), (2, -2), (3, -1), (4, 0), (3, 1),
                  (2, 2), (1, 3), (0, 4), (-1, 3), (-2, 2), (-3, 1),
                  (-4, 0), (-3, -1), (-2, -2), (-1, -3))
        square4 = ((-4, -4), (-4, 4), (4, 4), (4, -4))

        def consider(cx, cy, pat, step, dist):
            nonlocal best
            probes = []
            for i in range(0, len(pat), step):
                ix = cx + ((pat[i][0] * dist) >> 2)
                iy = cy + ((pat[i][1] * dist) >> 2)
                if abs(ix) <= sr and abs(iy) <= sr:
                    probes.append((ix, iy))
            if not probes:
                return False
            pb = min(costs_at(probes))
            if pb[0] < best[0]:
                best = pb
                return True
            return False

        # dense full-res ME field: extra high-quality seeds from the
        # whole-picture exhaustive sweep (native full_pel_search has_dense
        # twin) — non-MET presets only (see the native comment)
        has_dense = (self.search_range >= 16 and not self.met
                     and not os.environ.get("TC_NO_DENSEME")
                     and not os.environ.get("TC_NO_LOWRES"))
        window = 64 if self.search_range >= 64 else 32
        max_counter = 3 if self.search_range >= 64 else 2
        raster_q = 240 if self.search_range >= 64 else 120

        def met_probe():
            # MET probe (Speed.h useMet fast/medium, Search.hpp:2110-2124):
            # +/-1 cross around the current best, +/-2 hexagon too for 32+
            # blocks; False = best is a local optimum
            cross4 = ((0, -4), (-4, 0), (0, 4), (4, 0))
            improved = consider(best[1][0], best[1][1], cross4, 1, 1)
            if not improved and (w >= 32 or h >= 32):
                hex6 = ((0, -8), (8, -4), (8, 4), (0, 8), (-8, 4), (-8, -4))
                improved = consider(best[1][0], best[1][1], hex6, 1, 1)
            return improved

        # remaining seeds (mvp, then the callers' hints), with the
        # reference's per-seed MET flow (Search.hpp:2104-2194): after any
        # seed that improves the running best — the zero MV always does —
        # probe around it; no improvement from the probe stops the whole
        # search there
        def try_seed(sx, sy):
            """Evaluate one seed MV; True = MET stop (native try_seed)."""
            nonlocal best
            if (sx, sy) == (0, 0):
                return False
            ((c, cand),) = costs_at([(sx, sy)])
            if (c, cand) < best:
                best = (c, cand)
                if self.met and not met_probe():
                    return True
            return False

        met_stop = self.met and not met_probe()
        if not met_stop:
            seq = [(mvp[0] >> 2, mvp[1] >> 2)] \
                + [(int(mx) >> 2, int(my) >> 2) for (mx, my) in seeds]
            for (sx, sy) in seq:
                if try_seed(sx, sy):
                    met_stop = True
                    break
        # dense full-res ME field winners for the cells under this PU —
        # evaluated as plain cost candidates (NO MET interleave: a strong
        # SAD-only winner must not early-terminate the search before the
        # rate-aware star runs; measured -0.8% BD at fast with try-seed
        # flow). Native twin: full_pel_search deval.
        if has_dense and not met_stop:
            dm, _dsad, wb, hb = self._dense_field(ref_plane)

            def dcell(px, py):
                bx = min(max(px >> 4, 0), wb - 1)
                by = min(max(py >> 4, 0), hb - 1)
                return (int(dm[by, bx, 0]), int(dm[by, bx, 1]))

            def deval(sx, sy):
                nonlocal best
                ((c, cand),) = costs_at([(sx, sy)])
                if (c, cand) < best:
                    best = (c, cand)

            s = dcell(x0 + w // 2, y0 + h // 2)
            deval(*s)
            if w >= 32 or h >= 32:
                for q in range(4):
                    sq = dcell(x0 + (3 * w // 4 if q & 1 else w // 4),
                               y0 + (3 * h // 4 if q & 2 else h // 4))
                    if sq != s:
                        deval(*sq)
        if met_stop:
            return best[1], best[0]

        # initial star around the seed winner (fixed center)
        cx, cy = best[1]
        dist_best = 0
        counter = 0
        step = 4
        dist = 1
        while dist <= window and counter < max_counter:
            if dist in (2, 8):
                step >>= 1
            if consider(cx, cy, star16, step, dist):
                dist_best = dist
                counter = 0
            else:
                counter += 1
            dist <<= 1
        if dist_best == 1:
            dist_best = 0
            consider(best[1][0], best[1][1], square4, 1, 1)
        if dist_best > 5 and self.search_range >= 16:
            # the initial star's winner came from far out: consult the
            # lowres pre-ME winners for the cells under this PU instead of
            # the raster sweep (native enc_core full_pel_search twin)
            sm, wb, hb = self._lowres_seed_field(ref_plane)

            def cell(px, py):
                bx = min(max(px >> 4, 0), wb - 1)
                by = min(max(py >> 4, 0), hb - 1)
                return (int(sm[by, bx, 0]), int(sm[by, bx, 1]))

            s = cell(x0 + w // 2, y0 + h // 2)
            cands = [s]
            if w >= 32 or h >= 32:
                for q in range(4):
                    sq = cell(x0 + (3 * w // 4 if q & 1 else w // 4),
                              y0 + (3 * h // 4 if q & 2 else h // 4))
                    if sq != s:
                        cands.append(sq)
            for (sx, sy) in cands:
                ((c, cand),) = costs_at([(sx, sy)])
                if (c, cand) < best:
                    best = (c, cand)
            dist_best = 5
        elif dist_best > 5:
            # raster sweep on a 5-pel grid (quarter-pel +/-raster_q)
            probes = []
            for qy in range(-raster_q, raster_q + 1, 20):
                for qx in range(-raster_q, raster_q + 1, 20):
                    ix, iy = qx >> 2, qy >> 2
                    if abs(ix) <= sr and abs(iy) <= sr:
                        probes.append((ix, iy))
            rb = min(costs_at(probes))
            if rb[0] < best[0]:
                best = rb
            dist_best = 5
        # star refinement until no distance improves
        while dist_best > 0:
            rx, ry = best[1]
            dist_best = 0
            step = 4
            dist = 1
            while dist <= window:
                if dist in (2, 8):
                    step >>= 1
                if consider(rx, ry, star16, step, dist):
                    dist_best = dist
                dist <<= 1
            if dist_best == 1:
                consider(rx, ry, square4, 1, 1)
                dist_best = 0
        if self.search_range >= 64:
            # final +/-1 cross descent (slow/medium; Search.hpp:2300-2335)
            cross4 = ((0, -4), (-4, 0), (0, 4), (4, 0))
            while consider(best[1][0], best[1][1], cross4, 1, 1):
                pass
        return best[1], best[0]

    def _interp_batch(self, plane, x0, y0, w, h, mvs):
        """14-bit luma predictions for several quarter-pel MVs at once.

        Bit-exact with per-MV interp_luma: the separable 8-tap filtering is
        shared across probes with a common horizontal phase (the usual case
        in the half/quarter-pel diamond, where only 3 unique fractional
        columns appear per step)."""
        from turingcodec_tpu_torch.decode.inter_pred import _gather_padded
        from turingcodec_tpu_torch.hevc.tables import LUMA_FILTER
        shift1 = self.bd - 8
        out = np.empty((len(mvs), h, w), np.int32)
        groups = {}
        for i, (mvx, mvy) in enumerate(mvs):
            groups.setdefault((x0 + (mvx >> 2), mvx & 3), []).append(
                (i, y0 + (mvy >> 2), mvy & 3))
        for (ix, fx), items in groups.items():
            r0 = min(iy - (3 if fy else 0) for (_, iy, fy) in items)
            r1 = max(iy + h + (4 if fy else 0) for (_, iy, fy) in items)
            if fx == 0:
                win = _gather_padded(plane, ix, r0, w, r1 - r0)
                for (i, iy, fy) in items:
                    o = iy - r0
                    if fy == 0:
                        out[i] = win[o:o + h] << (14 - self.bd)
                    else:
                        f = LUMA_FILTER[fy]
                        acc = np.zeros((h, w), np.int32)
                        for k in range(8):
                            acc += f[k] * win[o - 3 + k:o - 3 + k + h]
                        out[i] = acc >> shift1
            else:
                win = _gather_padded(plane, ix - 3, r0, w + 7, r1 - r0)
                fh = LUMA_FILTER[fx]
                hint = np.zeros((r1 - r0, w), np.int32)
                for k in range(8):
                    hint += fh[k] * win[:, k:k + w]
                for (i, iy, fy) in items:
                    o = iy - r0
                    if fy == 0:
                        out[i] = hint[o:o + h] >> shift1
                    else:
                        tmp = hint[o - 3:o - 3 + h + 7] >> shift1
                        fv = LUMA_FILTER[fy]
                        acc = np.zeros((h, w), np.int64)
                        for k in range(8):
                            acc += fv[k] * tmp[k:k + h].astype(np.int64)
                        out[i] = acc >> 6
        return out

    def _sub_pel_refine(self, orig, ref_pic, x0, y0, w, h, int_mv, mvp):
        """Half then quarter pel 8-neighbour refinement on SATD, with the 8
        probes of each step interpolated in one shared-filter batch."""
        from turingcodec_tpu_torch.encode.sweep import satd_many
        plane = ref_pic.planes[0]
        bd = self.bd
        sh4 = 14 - bd
        blk = 8 if (min(w, h) >= 8 and w % 8 == 0 and h % 8 == 0) else 4
        cache = {}

        def costs(mvs):
            fresh = [mv for mv in mvs if mv not in cache]
            if fresh:
                preds = self._interp_batch(plane, x0, y0, w, h, fresh)
                preds = np.clip((preds + (1 << (sh4 - 1))) >> sh4, 0,
                                (1 << bd) - 1)
                sat = satd_many(orig, preds, blk)
                for mv, s in zip(fresh, sat):
                    cache[mv] = float(s) + self.lam_me * _mv_bits(
                        mv[0] - mvp[0], mv[1] - mvp[1])
            return [(cache[mv], mv) for mv in mvs]

        best = min(costs([(int_mv[0] * 4, int_mv[1] * 4)]))
        # fast preset: half-pel only (Speed.h subpel gating)
        steps = (2, 1) if self.rd_candidates >= 2 else (2,)
        for step in steps:
            bx, by = best[1]
            c = min(costs([(bx + dx, by + dy)
                           for (dx, dy) in ((step, 0), (-step, 0), (0, step),
                                            (0, -step), (step, step),
                                            (-step, -step), (step, -step),
                                            (-step, step))]))
            if c[0] < best[0]:
                best = c
        return best[1]

    def _bi_refine(self, orig, x0, y0, w, h, mv_bi, uni_mvps):
        """One alternating pass of bi-prediction refinement: for L1 then
        L0, hold the other list's 14-bit prediction fixed and diamond-step
        this list's MV at sub-pel on bi-combined SATD (the reference's
        searchMotionBi, Search.hpp:1498)."""
        from turingcodec_tpu_torch.encode.sweep import satd_many
        bd = self.bd
        shift = 14 - bd
        maxv = (1 << bd) - 1
        blk = 8 if (min(w, h) >= 8 and w % 8 == 0 and h % 8 == 0) else 4
        steps = (2, 1) if self.rd_candidates >= 2 else (2,)
        mv_bi = [tuple(mv_bi[0]), tuple(mv_bi[1])]
        for lx in (1, 0):
            other = 1 - lx
            o14 = self._interp_batch(self.ref_lists[other][0].planes[0],
                                     x0, y0, w, h, [mv_bi[other]])[0]
            plane = self.ref_lists[lx][0].planes[0]
            mvp = uni_mvps[lx][0]
            cache = {}

            def costs(mvs):
                fresh = [mv for mv in mvs if mv not in cache]
                if fresh:
                    t14 = self._interp_batch(plane, x0, y0, w, h, fresh)
                    preds = np.clip(
                        (t14 + (o14 + (1 << shift))) >> (shift + 1),
                        0, maxv)
                    sat = satd_many(orig, preds, blk)
                    for mv, s in zip(fresh, sat):
                        cache[mv] = float(s) + self.lam_me * _mv_bits(
                            mv[0] - mvp[0], mv[1] - mvp[1])
                return [(cache[mv], mv) for mv in mvs]

            best = min(costs([mv_bi[lx]]))
            for step in steps:
                bx, by = best[1]
                c = min(costs([(bx + dx, by + dy)
                               for (dx, dy) in ((step, 0), (-step, 0),
                                                (0, step), (0, -step),
                                                (step, step), (-step, -step),
                                                (step, -step),
                                                (-step, step))]))
                if c[0] < best[0]:
                    best = c
            mv_bi[lx] = best[1]
        return mv_bi

    # ------------------------------------------------------------------
    def _search_pu(self, px, py, pw, ph, cb_info, part_idx, part_mode):
        """Pick motion for one PU by SATD + lambda_me * bits over the merge
        list and uni-directional AMVP (Search<prediction_unit> analogue).
        Returns ("merge", idx, cand) or ("amvp", info) with info as in
        _encode_inter_cu."""
        from turingcodec_tpu_torch.ops.metrics import satd_np
        x0, y0, size = cb_info[0], cb_info[1], cb_info[2]
        orig = self.orig[0][py:py + ph, px:px + pw].astype(np.int32)
        blk = 8 if (min(pw, ph) >= 8 and pw % 8 == 0 and ph % 8 == 0) else 4
        deriver = self._get_deriver()
        merge_cands = deriver.merge_candidates(x0, y0, size, px, py, pw, ph,
                                               part_idx, part_mode)
        best = None
        seen = set()
        for mi, c in enumerate(merge_cands):
            # dedup on the RAW candidate (list identity), but predict and
            # commit the small-PU-cleared motion: bi is forbidden for
            # 8x4/4x8 PUs, L1 dropped after selection (spec 8.5.3.2.1 —
            # the decoder applies the same rule, mvp.py:381)
            key = (c.pred_flags, c.mv, c.ref_idx)
            if key in seen or not (c.pred_flags[0] or c.pred_flags[1]):
                continue
            seen.add(key)
            if pw + ph == 12 and c.pred_flags[0] and c.pred_flags[1]:
                c = MotionCand(pred_flags=(1, 0),
                               mv=(c.mv[0], (0, 0)),
                               ref_idx=(c.ref_idx[0], -1))
            pred = self._pred_luma_for_motion(c.pred_flags, c.mv, c.ref_idx,
                                              px, py, pw, ph)
            cost = satd_np(orig, pred, blk) + self.lam_me * (2 + mi)
            if best is None or cost < best[0]:
                best = (cost, "merge", mi, c)
        n_lists = 2 if (self.sh.is_b and self.ref_lists[1]) else 1
        for lx in range(n_lists):
            mvps = deriver.amvp(px, py, pw, ph, lx, 0, cb_info)
            ref = self.ref_lists[lx][0]
            seeds = [mvps[1]] + [c.mv[lx] for c in merge_cands
                                 if c.pred_flags[lx]]
            if lx in self._prev_int_mv:
                seeds.append(self._prev_int_mv[lx])
            int_mv, _ = self._full_pel_search(orig, ref.planes[0], px, py,
                                              pw, ph, mvps[0], seeds)
            mv = self._sub_pel_refine(orig, ref, px, py, pw, ph, int_mv,
                                      mvps[0])
            bits0 = _mv_bits(mv[0] - mvps[0][0], mv[1] - mvps[0][1])
            bits1 = _mv_bits(mv[0] - mvps[1][0], mv[1] - mvps[1][1])
            mvp_flag = int(bits1 < bits0)
            mvd = (mv[0] - mvps[mvp_flag][0], mv[1] - mvps[mvp_flag][1])
            flags = (1, 0) if lx == 0 else (0, 1)
            mvs = (mv, mv)
            pred = self._pred_luma_for_motion(flags, mvs, (0, 0),
                                              px, py, pw, ph)
            cost = satd_np(orig, pred, blk) \
                + self.lam_me * (3 + min(bits0, bits1))
            if best is None or cost < best[0]:
                best = (cost, "amvp", lx, {lx: (mv, mvd, mvp_flag)})
        return best[1:]

    def _commit_pu_motion(self, px, py, pw, ph, choice):
        """Write one PU's motion fields into the plan (before the next PU's
        derivation, which depends on them)."""
        plan = self.plan
        sl = (slice(py >> 2, (py + ph) >> 2), slice(px >> 2, (px + pw) >> 2))
        kind = choice[0]
        if kind == "merge":
            _, idx, c = choice
            plan.merge_flag[sl] = 1
            plan.merge_idx[sl] = idx
            for lx in (0, 1):
                if c.pred_flags[lx]:
                    plan.ref_idx[(lx,) + sl] = c.ref_idx[lx]
                    plan.mv[(lx,) + sl] = c.mv[lx]
                    plan.ref_poc[(lx,) + sl] = \
                        self.ref_lists[lx][c.ref_idx[lx]].poc
                else:
                    plan.ref_idx[(lx,) + sl] = -1
                    plan.mv[(lx,) + sl] = 0
        else:
            _, _, info = choice
            plan.merge_flag[sl] = 0
            for lx in (0, 1):
                if lx in info:
                    mv_l, mvd_l, mvp_f = info[lx]
                    plan.ref_idx[(lx,) + sl] = 0
                    plan.mv[(lx,) + sl] = mv_l
                    plan.ref_poc[(lx,) + sl] = self.ref_lists[lx][0].poc
                    plan.mvd[(lx,) + sl] = mvd_l
                    plan.mvp_flag[(lx,) + sl] = mvp_f
                else:
                    plan.ref_idx[(lx,) + sl] = -1
                    plan.mv[(lx,) + sl] = 0

    def _encode_inter_smp(self, x0, y0, log2, depth, part) -> float:
        """Two-PU SMP inter CU (PART_2NxN / PART_Nx2N) with the forced
        one-level transform split (spec 7.3.8.8 interSplitFlag)."""
        plan, sps = self.plan, self.sps
        size = 1 << log2
        half = size >> 1
        sl = (slice(y0 >> 2, (y0 + size) >> 2),
              slice(x0 >> 2, (x0 + size) >> 2))

        plan.ct_depth[sl] = depth
        plan.cu_pred_mode[sl] = 0
        plan.part_mode[sl] = part
        plan.cu_size_log2[sl] = log2
        plan.cu_id[sl] = self.next_id[0]
        plan.skip_flag[sl] = 0
        self.next_id[0] += 1

        from turingcodec_tpu_torch.encode.ctu_write import _pu_rects
        pus = _pu_rects(x0, y0, size, part)

        pred_y = np.zeros((size, size), np.int32)
        pred_cb = np.zeros((half, half), np.int32)
        pred_cr = np.zeros((half, half), np.int32)
        pu_records = []
        for part_idx, (px, py, pw, ph) in enumerate(pus):
            psl = (slice(py >> 2, (py + ph) >> 2),
                   slice(px >> 2, (px + pw) >> 2))
            plan.pu_id[psl] = self.next_id[1]
            self.next_id[1] += 1
            cb_info = (x0, y0, size, pw, ph, part_idx)
            choice = self._search_pu(px, py, pw, ph, cb_info, part_idx, part)
            self._commit_pu_motion(px, py, pw, ph, choice)
            b = (py >> 2, px >> 2)
            flags = tuple(int(plan.ref_idx[lx, b[0], b[1]] >= 0)
                          for lx in (0, 1))
            mvs = tuple(tuple(int(v) for v in plan.mv[lx, b[0], b[1]])
                        for lx in (0, 1))
            refs = tuple(max(0, int(plan.ref_idx[lx, b[0], b[1]]))
                         for lx in (0, 1))
            p = self._pred_for_motion(flags, mvs, refs, px, py, pw, ph)
            pred_y[py - y0:py - y0 + ph, px - x0:px - x0 + pw] = p[0]
            cy0, cx0 = (py - y0) >> 1, (px - x0) >> 1
            pred_cb[cy0:cy0 + (ph >> 1), cx0:cx0 + (pw >> 1)] = p[1]
            pred_cr[cy0:cy0 + (ph >> 1), cx0:cx0 + (pw >> 1)] = p[2]
            pu_records.append((choice, pw, ph))

        # residual: forced TT split -> four luma TUs at log2-1 (chroma at
        # log2-2), committed in z-order so rate contexts track the writer
        orig_y = self.orig[0][y0:y0 + size, x0:x0 + size].astype(np.int32)
        cx, cy, cs = x0 >> 1, y0 >> 1, size >> 1
        orig_cb = self.orig[1][cy:cy + cs, cx:cx + cs].astype(np.int32)
        orig_cr = self.orig[2][cy:cy + cs, cx:cx + cs].astype(np.int32)
        rec_y = np.zeros((size, size), np.int32)
        rec_cb = np.zeros((cs, cs), np.int32)
        rec_cr = np.zeros((cs, cs), np.int32)
        dist = 0.0
        qh = half
        for (dy, dx) in ((0, 0), (0, qh), (qh, 0), (qh, qh)):
            oy = orig_y[dy:dy + qh, dx:dx + qh]
            pyq = pred_y[dy:dy + qh, dx:dx + qh]
            coeffs = forward_transform_np(oy - pyq, self.bd, False)
            levels = self._quantize_rd(coeffs,
                                       self.qp + sps.qp_bd_offset_y,
                                       self.bd, log2 - 1, False, 0, 0,
                                       cbf=("cbf_luma", 0))
            if levels.any():
                d = dequant_block(levels, self.qp + sps.qp_bd_offset_y,
                                  self.bd, log2 - 1)
                rq = np.clip(pyq + inverse_transform(d, self.bd, False),
                             0, (1 << self.bd) - 1)
            else:
                rq = pyq
            rec_y[dy:dy + qh, dx:dx + qh] = rq
            plan.coeff_y[y0 + dy:y0 + dy + qh, x0 + dx:x0 + dx + qh] = levels
            bl = (slice((y0 + dy) >> 2, (y0 + dy + qh) >> 2),
                  slice((x0 + dx) >> 2, (x0 + dx + qh) >> 2))
            plan.cbf_y[bl] = int(levels.any())
            plan.tu_log2[bl] = log2 - 1
            plan.tu_id[bl] = self.next_id[2]
            self.next_id[2] += 1
            dist += float(((rq - oy) ** 2).sum())

            if log2 == 3:
                continue  # 8x8 SMP: one 4x4 chroma TB pair after the loop
            ch = qh >> 1
            cdy, cdx = dy >> 1, dx >> 1
            for ci, (o_c, p_c, r_c, qp_c, coeff_pl, cbf_pl) in enumerate((
                    (orig_cb, pred_cb, rec_cb, self.qp_cb,
                     plan.coeff_cb, plan.cbf_cb),
                    (orig_cr, pred_cr, rec_cr, self.qp_cr,
                     plan.coeff_cr, plan.cbf_cr))):
                oc = o_c[cdy:cdy + ch, cdx:cdx + ch]
                pc = p_c[cdy:cdy + ch, cdx:cdx + ch]
                cf = forward_transform_np(oc - pc, sps.bit_depth_c, False)
                lv = self._quantize_rd(cf, qp_c + sps.qp_bd_offset_c,
                                       sps.bit_depth_c, log2 - 2, False,
                                       ci + 1, 0, cbf=("cbf_chroma", 1))
                if lv.any():
                    dd = dequant_block(lv, qp_c + sps.qp_bd_offset_c,
                                       sps.bit_depth_c, log2 - 2)
                    rc = np.clip(
                        pc + inverse_transform(dd, sps.bit_depth_c, False),
                        0, (1 << sps.bit_depth_c) - 1)
                else:
                    rc = pc
                r_c[cdy:cdy + ch, cdx:cdx + ch] = rc
                coeff_pl[cy + cdy:cy + cdy + ch, cx + cdx:cx + cdx + ch] = lv
                cbf_pl[bl] = int(lv.any())
                dist += float(((rc - oc) ** 2).sum())
        if log2 == 3:
            # 8x8 SMP: chroma stays one 4x4 TB pair (no split below an
            # 8x8 luma; the writer's chroma_last path) covering the CU
            sl8 = (slice(y0 >> 2, (y0 + size) >> 2),
                   slice(x0 >> 2, (x0 + size) >> 2))
            for ci, (o_c, p_c, r_c, qp_c, coeff_pl, cbf_pl) in enumerate((
                    (orig_cb, pred_cb, rec_cb, self.qp_cb,
                     plan.coeff_cb, plan.cbf_cb),
                    (orig_cr, pred_cr, rec_cr, self.qp_cr,
                     plan.coeff_cr, plan.cbf_cr))):
                cf = forward_transform_np(o_c - p_c, sps.bit_depth_c,
                                          False)
                lv = self._quantize_rd(cf, qp_c + sps.qp_bd_offset_c,
                                       sps.bit_depth_c, 2, False,
                                       ci + 1, 0, cbf=("cbf_chroma", 0))
                if lv.any():
                    dd = dequant_block(lv, qp_c + sps.qp_bd_offset_c,
                                       sps.bit_depth_c, 2)
                    rc = np.clip(
                        p_c + inverse_transform(dd, sps.bit_depth_c,
                                                False),
                        0, (1 << sps.bit_depth_c) - 1)
                else:
                    rc = p_c
                r_c[:, :] = rc
                coeff_pl[cy:cy + cs, cx:cx + cs] = lv
                cbf_pl[sl8] = int(lv.any())
                if (self.pps.transform_skip_enabled_flag):
                    tsmap = (plan.transform_skip_cb if ci == 0
                             else plan.transform_skip_cr)
                    tsmap[cy >> 1, cx >> 1] = 0
                dist += float(((rc - o_c) ** 2).sum())

        self.recon[0][y0:y0 + size, x0:x0 + size] = rec_y
        self.recon[1][cy:cy + cs, cx:cx + cs] = rec_cb
        self.recon[2][cy:cy + cs, cx:cx + cs] = rec_cr

        # exact writer bins of the whole CU, in order (the only candidate
        # of this part mode — committed immediately)
        from turingcodec_tpu_torch.cabac.engine import ctx_index
        lv_y = plan.coeff_y[y0:y0 + size, x0:x0 + size]
        lv_cb = plan.coeff_cb[cy:cy + cs, cx:cx + cs]
        lv_cr = plan.coeff_cr[cy:cy + cs, cx:cx + cs]
        est = self._mb_est()
        self._emit_cu_skip(est, x0, y0, 0)
        est.encode_decision(ctx_index("pred_mode_flag"), 0)
        self._emit_inter_part_mode(est, part, log2)
        for (choice, pw, ph) in pu_records:
            if choice[0] == "merge":
                self._emit_merge_pu(est, choice[1])
            else:
                self._emit_amvp_pu(est, depth, pw, ph, choice[2])
        has = bool(lv_y.any() or lv_cb.any() or lv_cr.any())
        est.encode_decision(ctx_index("rqt_root_cbf"), int(has))
        if has:
            if log2 == 3:
                self._emit_tt_split8(est, lv_y, lv_cb, lv_cr)
            else:
                self._emit_tt_split(est, log2, lv_y, lv_cb, lv_cr)
        self._mb_adopt(est)
        return dist + self.lam * (est.frac_bits / 256.0)

    # ------------------------------------------------------------------
    def _finish_inter_cu_split_tt(self, x0, y0, log2, candidates,
                                  merge_cands, orig_y, orig_cb, orig_cr
                                  ) -> float:
        """RD finish for CUs above the max TB size (64x64): the transform
        tree is force-split once, so residuals are four TUs at log2-1
        (chroma at log2-2 each)."""
        plan, sps, sh = self.plan, self.sps, self.sh
        size = 1 << log2
        half = size >> 1
        sl = (slice(y0 >> 2, (y0 + size) >> 2),
              slice(x0 >> 2, (x0 + size) >> 2))
        cx, cy, cs = x0 >> 1, y0 >> 1, size >> 1
        qh = half
        ch = qh >> 1
        best = None
        z0 = np.zeros((size, size), np.int32)
        zc0 = np.zeros((cs, cs), np.int32)
        # depth of this CU in the quadtree (for inter_pred_idc ctx)
        depth = int(plan.ct_depth[y0 >> 2, x0 >> 2])
        for kind, idx, info, pred in candidates:
            py, pcb, pcr = pred
            # FDM/FDAM: zero-residual champion -> zero-residual-only trial
            # (same rule as _encode_inter_cu's stage-2 loop)
            if self.fdam and best is not None and not best[10]:
                dist0 = float(((py - orig_y) ** 2).sum()) \
                    + float(((pcb - orig_cb) ** 2).sum()) \
                    + float(((pcr - orig_cr) ** 2).sum())
                e0 = self._cand_est_2nx2n(x0, y0, log2, depth, kind, idx,
                                          info, z0, zc0, zc0,
                                          split_tt=True)
                cost0 = dist0 + self.lam * (e0.frac_bits / 256.0)
                if cost0 < best[0]:
                    best = (cost0, kind, idx, info, z0, zc0, zc0,
                            py.copy(), pcb.copy(), pcr.copy(), False, e0)
                continue
            dist = 0.0
            lv_y = np.zeros((size, size), np.int32)
            lv_cb = np.zeros((cs, cs), np.int32)
            lv_cr = np.zeros((cs, cs), np.int32)
            rec_y = np.zeros((size, size), np.int32)
            rec_cb = np.zeros((cs, cs), np.int32)
            rec_cr = np.zeros((cs, cs), np.int32)
            for (dy, dx) in ((0, 0), (0, qh), (qh, 0), (qh, qh)):
                oy = orig_y[dy:dy + qh, dx:dx + qh]
                pq = py[dy:dy + qh, dx:dx + qh]
                coeffs = forward_transform_np(oy - pq, self.bd, False)
                levels = self._quantize_rd(coeffs,
                                           self.qp + sps.qp_bd_offset_y,
                                           self.bd, log2 - 1, False, 0, 0,
                                           cbf=("cbf_luma", 0))
                if levels.any():
                    d = dequant_block(levels, self.qp + sps.qp_bd_offset_y,
                                      self.bd, log2 - 1)
                    rq = np.clip(pq + inverse_transform(d, self.bd, False),
                                 0, (1 << self.bd) - 1)
                else:
                    rq = pq
                lv_y[dy:dy + qh, dx:dx + qh] = levels
                rec_y[dy:dy + qh, dx:dx + qh] = rq
                dist += float(((rq - oy) ** 2).sum())
                cdy, cdx = dy >> 1, dx >> 1
                for (o_c, p_c, lvp, recp, qp_c) in (
                        (orig_cb, pcb, lv_cb, rec_cb, self.qp_cb),
                        (orig_cr, pcr, lv_cr, rec_cr, self.qp_cr)):
                    oc = o_c[cdy:cdy + ch, cdx:cdx + ch]
                    pc = p_c[cdy:cdy + ch, cdx:cdx + ch]
                    cf = forward_transform_np(oc - pc, sps.bit_depth_c,
                                              False)
                    lv = self._quantize_rd(cf, qp_c + sps.qp_bd_offset_c,
                                           sps.bit_depth_c, log2 - 2, False,
                                           1 if lvp is lv_cb else 2, 0,
                                           cbf=("cbf_chroma", 1))
                    if lv.any():
                        dd = dequant_block(lv, qp_c + sps.qp_bd_offset_c,
                                           sps.bit_depth_c, log2 - 2)
                        rc = np.clip(
                            pc + inverse_transform(dd, sps.bit_depth_c,
                                                   False),
                            0, (1 << sps.bit_depth_c) - 1)
                    else:
                        rc = pc
                    lvp[cdy:cdy + ch, cdx:cdx + ch] = lv
                    recp[cdy:cdy + ch, cdx:cdx + ch] = rc
                    dist += float(((rc - oc) ** 2).sum())
            est = self._cand_est_2nx2n(x0, y0, log2, depth, kind, idx,
                                       info, lv_y, lv_cb, lv_cr,
                                       split_tt=True)
            cost = dist + self.lam * (est.frac_bits / 256.0)
            has_coeff = bool(lv_y.any() or lv_cb.any() or lv_cr.any())
            if best is None or cost < best[0]:
                best = (cost, kind, idx, info, lv_y.copy(), lv_cb.copy(),
                        lv_cr.copy(), rec_y.copy(), rec_cb.copy(),
                        rec_cr.copy(), has_coeff, est)
            # zero-residual variant (skip / rqt_root_cbf=0 trial)
            if has_coeff:
                dist0 = float(((py - orig_y) ** 2).sum()) \
                    + float(((pcb - orig_cb) ** 2).sum()) \
                    + float(((pcr - orig_cr) ** 2).sum())
                e0 = self._cand_est_2nx2n(x0, y0, log2, depth, kind, idx,
                                          info, z0, zc0, zc0,
                                          split_tt=True)
                cost0 = dist0 + self.lam * (e0.frac_bits / 256.0)
                if cost0 < best[0]:
                    best = (cost0, kind, idx, info, z0, zc0, zc0,
                            py.copy(), pcb.copy(), pcr.copy(), False, e0)

        (cost, kind, idx, info, lv_y, lv_cb, lv_cr, rec_y, rec_cb, rec_cr,
         has_coeff, best_est) = best

        # commit motion (identical to the single-TU path)
        if kind == "merge":
            c = merge_cands[idx]
            plan.merge_flag[sl] = 1
            plan.merge_idx[sl] = idx
            plan.skip_flag[sl] = int(not has_coeff)
            for lx in (0, 1):
                if c.pred_flags[lx]:
                    plan.ref_idx[(lx,) + sl] = c.ref_idx[lx]
                    plan.mv[(lx,) + sl] = c.mv[lx]
                    plan.ref_poc[(lx,) + sl] = \
                        self.ref_lists[lx][c.ref_idx[lx]].poc
                else:
                    plan.ref_idx[(lx,) + sl] = -1
                    plan.mv[(lx,) + sl] = 0
        else:
            plan.merge_flag[sl] = 0
            plan.skip_flag[sl] = 0
            for lx in (0, 1):
                if lx in info:
                    mv_l, mvd_l, mvp_f = info[lx]
                    plan.ref_idx[(lx,) + sl] = 0
                    plan.mv[(lx,) + sl] = mv_l
                    plan.ref_poc[(lx,) + sl] = self.ref_lists[lx][0].poc
                    plan.mvd[(lx,) + sl] = mvd_l
                    plan.mvp_flag[(lx,) + sl] = mvp_f
                else:
                    plan.ref_idx[(lx,) + sl] = -1
                    plan.mv[(lx,) + sl] = 0

        plan.tu_log2[sl] = log2 - 1
        self._mb_adopt(best_est)
        # per-quadrant TU records (z-scan)
        for (dy, dx) in ((0, 0), (0, qh), (qh, 0), (qh, qh)):
            bl = (slice((y0 + dy) >> 2, (y0 + dy + qh) >> 2),
                  slice((x0 + dx) >> 2, (x0 + dx + qh) >> 2))
            plan.tu_id[bl] = self.next_id[2]
            self.next_id[2] += 1
            lq = lv_y[dy:dy + qh, dx:dx + qh]
            cdy, cdx = dy >> 1, dx >> 1
            lcb = lv_cb[cdy:cdy + ch, cdx:cdx + ch]
            lcr = lv_cr[cdy:cdy + ch, cdx:cdx + ch]
            plan.cbf_y[bl] = int(lq.any())
            plan.cbf_cb[bl] = int(lcb.any())
            plan.cbf_cr[bl] = int(lcr.any())
        plan.coeff_y[y0:y0 + size, x0:x0 + size] = lv_y
        plan.coeff_cb[cy:cy + cs, cx:cx + cs] = lv_cb
        plan.coeff_cr[cy:cy + cs, cx:cx + cs] = lv_cr
        self.recon[0][y0:y0 + size, x0:x0 + size] = rec_y
        self.recon[1][cy:cy + cs, cx:cx + cs] = rec_cb
        self.recon[2][cy:cy + cs, cx:cx + cs] = rec_cr
        return cost

    # ------------------------------------------------------------------
    def _encode_inter_cu(self, x0, y0, log2, depth) -> float:
        plan, sps, sh = self.plan, self.sps, self.sh
        self._aps_quad = None
        size = 1 << log2
        sl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
        orig_y = self.orig[0][y0:y0 + size, x0:x0 + size].astype(np.int32)
        cx, cy, cs = x0 >> 1, y0 >> 1, size >> 1
        orig_cb = self.orig[1][cy:cy + cs, cx:cx + cs].astype(np.int32)
        orig_cr = self.orig[2][cy:cy + cs, cx:cx + cs].astype(np.int32)

        # plan fields common to all inter choices
        plan.ct_depth[sl] = depth
        plan.cu_pred_mode[sl] = 0
        plan.part_mode[sl] = T.PART_2Nx2N
        plan.cu_size_log2[sl] = log2
        plan.cu_id[sl] = self.next_id[0]
        plan.pu_id[sl] = self.next_id[1]
        self.next_id[0] += 1
        self.next_id[1] += 1

        deriver = self._get_deriver()
        merge_cands = deriver.merge_candidates(
            x0, y0, size, x0, y0, size, size, 0, T.PART_2Nx2N)

        # stage 1: luma-only SATD ranking over all candidates (the
        # measurePuCost pruning of Search.hpp:1656 — full RD only for the
        # survivors)
        from turingcodec_tpu_torch.ops.metrics import satd_np
        scored = []  # (satd_cost, kind, idx, info, motion)
        seen = set()
        for mi, c in enumerate(merge_cands):
            key = (c.pred_flags, c.mv, c.ref_idx)
            if key in seen:
                continue
            seen.add(key)
            if not (c.pred_flags[0] or c.pred_flags[1]):
                continue
            motion = (c.pred_flags, c.mv, c.ref_idx)
            pl = self._pred_luma_for_motion(*motion, x0, y0, size, size)
            sc = satd_np(orig_y, pl, 8) + self.lam_me * (2 + mi)
            scored.append((sc, "merge", mi, c, motion))

        # ESD (early skip detection, Speed.h useEsd medium/fast;
        # searchInterCu's esd break, Search.hpp:1059): full residual trial
        # of the SATD-best merge candidate BEFORE motion estimation — when
        # it quantizes to all-zero, commit the skip CU outright and bypass
        # ME + stage 2 (native enc_core twin)
        if getattr(self, "esd", False) and scored:
            sc0, _k0, mi0, c0, motion0 = min(scored, key=lambda t: t[0])
            py, pcb, pcr = self._pred_for_motion(*motion0, x0, y0, size,
                                                 size)
            if log2 <= sps.max_tb_log2_size_y:
                lv = self._quantize_rd(
                    forward_transform_np(orig_y - py, self.bd, False),
                    self.qp + sps.qp_bd_offset_y, self.bd, log2, False, 0,
                    0, cbf=("rqt_root_cbf", 0))
                zero = not lv.any()
                if zero:
                    for ci, (o, p, qp) in enumerate(
                            ((orig_cb, pcb, self.qp_cb),
                             (orig_cr, pcr, self.qp_cr))):
                        lvc = self._quantize_rd(
                            forward_transform_np(o - p, sps.bit_depth_c,
                                                 False),
                            qp + sps.qp_bd_offset_c, sps.bit_depth_c,
                            log2 - 1, False, ci + 1, 0,
                            cbf=("cbf_chroma", 0))
                        if lvc.any():
                            zero = False
                            break
            else:
                # CU above the max TB (64x64): quadrant transforms, the
                # split-tree ctx indices (the forced-split stage-2 twin)
                zero = True
                qh, ch = size >> 1, size >> 2
                for (dy, dx) in ((0, 0), (0, qh), (qh, 0), (qh, qh)):
                    if not zero:
                        break
                    lv = self._quantize_rd(
                        forward_transform_np(
                            orig_y[dy:dy + qh, dx:dx + qh]
                            - py[dy:dy + qh, dx:dx + qh], self.bd, False),
                        self.qp + sps.qp_bd_offset_y, self.bd, log2 - 1,
                        False, 0, 0, cbf=("cbf_luma", 0))
                    if lv.any():
                        zero = False
                        break
                    cdy, cdx = dy >> 1, dx >> 1
                    for ci, (o, p, qp) in enumerate(
                            ((orig_cb, pcb, self.qp_cb),
                             (orig_cr, pcr, self.qp_cr))):
                        lvc = self._quantize_rd(
                            forward_transform_np(
                                o[cdy:cdy + ch, cdx:cdx + ch]
                                - p[cdy:cdy + ch, cdx:cdx + ch],
                                sps.bit_depth_c, False),
                            qp + sps.qp_bd_offset_c, sps.bit_depth_c,
                            log2 - 2, False, ci + 1, 0,
                            cbf=("cbf_chroma", 1))
                        if lvc.any():
                            zero = False
                            break
            if zero:
                dist0 = float(((py - orig_y) ** 2).sum()) \
                    + float(((pcb - orig_cb) ** 2).sum()) \
                    + float(((pcr - orig_cr) ** 2).sum())
                est = self._mb_live()
                self._emit_skip_cu(est, x0, y0, mi0)
                self._ctu_frac += est.frac_bits
                cost0 = dist0 + self.lam * (est.frac_bits / 256.0)
                plan.merge_flag[sl] = 1
                plan.merge_idx[sl] = mi0
                plan.skip_flag[sl] = 1
                for lx in (0, 1):
                    if c0.pred_flags[lx]:
                        plan.ref_idx[(lx,) + sl] = c0.ref_idx[lx]
                        plan.mv[(lx,) + sl] = c0.mv[lx]
                        plan.ref_poc[(lx,) + sl] = \
                            self.ref_lists[lx][c0.ref_idx[lx]].poc
                    else:
                        plan.ref_idx[(lx,) + sl] = -1
                        plan.mv[(lx,) + sl] = 0
                plan.tu_log2[sl] = min(log2, sps.max_tb_log2_size_y)
                plan.tu_id[sl] = self.next_id[2]
                self.next_id[2] += 1
                plan.coeff_y[y0:y0 + size, x0:x0 + size] = 0
                plan.coeff_cb[cy:cy + cs, cx:cx + cs] = 0
                plan.coeff_cr[cy:cy + cs, cx:cx + cs] = 0
                plan.cbf_y[sl] = 0
                plan.cbf_cb[sl] = 0
                plan.cbf_cr[sl] = 0
                if log2 - 1 == 2 and self.pps.transform_skip_enabled_flag:
                    plan.transform_skip_cb[cy >> 1, cx >> 1] = 0
                    plan.transform_skip_cr[cy >> 1, cx >> 1] = 0
                self.recon[0][y0:y0 + size, x0:x0 + size] = py
                self.recon[1][cy:cy + cs, cx:cx + cs] = pcb
                self.recon[2][cy:cy + cs, cx:cx + cs] = pcr
                return cost0

        # motion estimation (AMVP) per list
        cb_info = (x0, y0, size, size, size, 0)
        best_uni = {}  # lx -> (mv, mvd, mvp_flag)
        uni_mvps = {}
        n_lists = 2 if (self.sh.is_b and self.ref_lists[1]) else 1
        for lx in range(n_lists):
            mvps = deriver.amvp(x0, y0, size, size, lx, 0, cb_info)
            uni_mvps[lx] = mvps
            ref = self.ref_lists[lx][0]
            seeds = [mvps[1]] + [c.mv[lx] for c in merge_cands
                                 if c.pred_flags[lx]]
            if lx in self._prev_int_mv:
                # previous 2Nx2N integer best (mvPreviousInteger2Nx2N seed;
                # row-local so WPP thread counts don't change results)
                seeds.append(self._prev_int_mv[lx])
            int_mv, _ = self._full_pel_search(orig_y, ref.planes[0], x0, y0,
                                              size, size, mvps[0], seeds)
            self._prev_int_mv[lx] = (4 * int_mv[0], 4 * int_mv[1])
            mv = self._sub_pel_refine(orig_y, ref, x0, y0, size, size, int_mv,
                                      mvps[0])
            bits0 = _mv_bits(mv[0] - mvps[0][0], mv[1] - mvps[0][1])
            bits1 = _mv_bits(mv[0] - mvps[1][0], mv[1] - mvps[1][1])
            mvp_flag = int(bits1 < bits0)
            mvd = (mv[0] - mvps[mvp_flag][0], mv[1] - mvps[mvp_flag][1])
            best_uni[lx] = (mv, mvd, mvp_flag)
            flags = (1, 0) if lx == 0 else (0, 1)
            motion = (flags, (mv, mv), (0, 0))
            pl = self._pred_luma_for_motion(*motion, x0, y0, size, size)
            sc = satd_np(orig_y, pl, 8) \
                + self.lam_me * (3 + min(bits0, bits1))
            scored.append((sc, "amvp", lx, {lx: (mv, mvd, mvp_flag)}, motion))
        if n_lists == 2:
            # bi candidate: start from the two best uni motions, then
            # alternately re-optimize each list's sub-pel MV against the
            # other's fixed 14-bit prediction (searchMotionBi,
            # Search.hpp:1498)
            mv_bi = [best_uni[0][0], best_uni[1][0]]
            mv_bi = self._bi_refine(orig_y, x0, y0, size, size, mv_bi,
                                    uni_mvps)
            info = {}
            for lx in (0, 1):
                mv = mv_bi[lx]
                mvps = uni_mvps[lx]
                b0 = _mv_bits(mv[0] - mvps[0][0], mv[1] - mvps[0][1])
                b1 = _mv_bits(mv[0] - mvps[1][0], mv[1] - mvps[1][1])
                fl = int(b1 < b0)
                info[lx] = (mv, (mv[0] - mvps[fl][0], mv[1] - mvps[fl][1]),
                            fl)
            motion = ((1, 1), (mv_bi[0], mv_bi[1]), (0, 0))
            pl = self._pred_luma_for_motion(*motion, x0, y0, size, size)
            sc = satd_np(orig_y, pl, 8) + self.lam_me * 6
            scored.append((sc, "amvp", 2, info, motion))

        # stage 2: full RD for the top candidates only; an adaptive 3rd
        # candidate joins when its SATD ranking cost is close to the
        # leader's (the reference RDs every PU mode; native twin)
        scored.sort(key=lambda t: t[0])
        keep = max(2, self.rd_candidates)
        if (self.rd_candidates <= 2 and len(scored) > keep
                and scored[keep][0] <= 1.15 * scored[0][0]):
            keep += 1
        candidates = [(kind, idx, info,
                       self._pred_for_motion(*motion, x0, y0, size, size))
                      for (_, kind, idx, info, motion) in scored[:keep]]

        if log2 > sps.max_tb_log2_size_y:
            return self._finish_inter_cu_split_tt(
                x0, y0, log2, candidates, merge_cands, orig_y, orig_cb,
                orig_cr)

        # inter RQT (Speed.h useRqt, slow preset; Search.hpp
        # Search<IfCbf<rqt_root_cbf, transform_tree>>): also try the
        # one-level transform split for 16x16/32x32 CUs and keep the
        # better tree (requires max_transform_hierarchy_depth_inter = 1)
        do_rqt = (getattr(self, "rqt", False) and log2 >= 4
                  and sps.max_transform_hierarchy_depth_inter >= 1)
        st_pre = self._snapshot(x0, y0, size) if do_rqt else None

        best = None
        z0 = np.zeros((size, size), np.int32)
        zc0 = np.zeros((cs, cs), np.int32)
        for kind, idx, info, pred in candidates:
            py, pcb, pcr = pred
            # FDM/FDAM (Speed.h useFdm/useFdam, Search.hpp:990,1008): once
            # a zero-residual champion exists, later candidates are
            # evaluated zero-residual only (no transform/quant trial)
            if self.fdam and best is not None and not best[8]:
                dist0 = float(((py - orig_y) ** 2).sum()) \
                    + float(((pcb - orig_cb) ** 2).sum()) \
                    + float(((pcr - orig_cr) ** 2).sum())
                e0 = self._cand_est_2nx2n(x0, y0, log2, depth, kind, idx,
                                          info, z0, zc0, zc0)
                cost0 = dist0 + self.lam * (e0.frac_bits / 256.0)
                if cost0 < best[0]:
                    best = (cost0, kind, idx, info, z0,
                            [zc0, zc0], py, [pcb, pcr], False, [0, 0], e0)
                continue
            # luma residual
            res = orig_y - py
            coeffs = forward_transform_np(res, self.bd, False)
            levels = self._quantize_rd(coeffs, self.qp + sps.qp_bd_offset_y,
                                       self.bd, log2, False, 0, 0,
                                       cbf=("rqt_root_cbf", 0))
            if levels.any():
                d = dequant_block(levels, self.qp + sps.qp_bd_offset_y,
                                  self.bd, log2)
                rec_y = np.clip(py + inverse_transform(d, self.bd, False),
                                0, (1 << self.bd) - 1)
            else:
                rec_y = py
            # chroma residual (4x4 chroma TBs of 8x8 CUs also try
            # transform skip when --tskip is on, Reconstruct.cpp:266)
            ts_on = (log2 - 1 == 2
                     and bool(self.pps.transform_skip_enabled_flag))
            recs_c = []
            levels_c = []
            ts_c = []
            for ci, (o, p, qp) in enumerate(((orig_cb, pcb, self.qp_cb),
                                             (orig_cr, pcr, self.qp_cr))):
                res_c = o - p
                cf = forward_transform_np(res_c, sps.bit_depth_c, False)
                lv = self._quantize_rd(cf, qp + sps.qp_bd_offset_c,
                                       sps.bit_depth_c, log2 - 1, False,
                                       ci + 1, 0, cbf=("cbf_chroma", 0))
                if lv.any():
                    dd = dequant_block(lv, qp + sps.qp_bd_offset_c,
                                       sps.bit_depth_c, log2 - 1)
                    rc = np.clip(p + inverse_transform(dd, sps.bit_depth_c,
                                                       False),
                                 0, (1 << sps.bit_depth_c) - 1)
                else:
                    rc = p
                tsf = 0
                if ts_on:
                    lv_ts, rc_ts = self._ts_variant(
                        res_c, p, qp + sps.qp_bd_offset_c,
                        sps.bit_depth_c, ci + 1, 0, False,
                        ("cbf_chroma", 0))
                    c_no = float(((rc - o) ** 2).sum()) + self.lam \
                        * self._residual_bits(lv, log2 - 1, ci + 1, 0,
                                              False)
                    c_ts = float(((rc_ts - o) ** 2).sum()) + self.lam \
                        * self._residual_bits(lv_ts, log2 - 1, ci + 1, 0,
                                              False)
                    if c_ts < c_no:
                        lv, rc, tsf = lv_ts, rc_ts, 1
                ts_c.append(tsf)
                recs_c.append(rc)
                levels_c.append(lv)

            dist = float(((rec_y - orig_y) ** 2).sum()) \
                + float(((recs_c[0] - orig_cb) ** 2).sum()) \
                + float(((recs_c[1] - orig_cr) ** 2).sum())
            est = self._cand_est_2nx2n(x0, y0, log2, depth, kind, idx,
                                       info, levels, levels_c[0],
                                       levels_c[1], ts_c[0], ts_c[1])
            cost = dist + self.lam * (est.frac_bits / 256.0)
            has_coeff = bool(levels.any() or levels_c[0].any()
                             or levels_c[1].any())
            if best is None or cost < best[0]:
                best = (cost, kind, idx, info, levels, levels_c,
                        rec_y, recs_c, has_coeff, ts_c, est)
            # zero-residual variant (the reference's skip / rqt_root_cbf=0
            # trial, Search.hpp searchMerge2Nx2N + rqt_root_cbf RDO): same
            # prediction, residual dropped entirely
            if has_coeff:
                dist0 = float(((py - orig_y) ** 2).sum()) \
                    + float(((pcb - orig_cb) ** 2).sum()) \
                    + float(((pcr - orig_cr) ** 2).sum())
                e0 = self._cand_est_2nx2n(x0, y0, log2, depth, kind, idx,
                                          info, z0, zc0, zc0)
                cost0 = dist0 + self.lam * (e0.frac_bits / 256.0)
                if cost0 < best[0]:
                    best = (cost0, kind, idx, info, z0,
                            [zc0, zc0], py, [pcb, pcr], False, [0, 0], e0)

        (cost, kind, idx, info, levels, levels_c, rec_y, recs_c,
         has_coeff, ts_best, best_est) = best

        # APS (Aps.h analyseResidueEnergy input): per-quadrant |residual|
        # of the champion's PREDICTION (Reconstruct.cpp:1283) for the
        # dispatch's 2NxN/Nx2N gating
        self._aps_quad = None
        if getattr(self, "aps", False) and log2 >= 4 \
                and self.rd_candidates >= 2:
            for k2, i2, _inf, pred2 in candidates:
                if k2 == kind and i2 == idx:
                    r = np.abs(orig_y - pred2[0])
                    qh2 = size >> 1
                    self._aps_quad = (
                        int(r[:qh2, :qh2].sum()), int(r[:qh2, qh2:].sum()),
                        int(r[qh2:, :qh2].sum()), int(r[qh2:, qh2:].sum()))
                    break

        # commit
        if kind == "merge":
            c = merge_cands[idx]
            plan.merge_flag[sl] = 1
            plan.merge_idx[sl] = idx
            plan.skip_flag[sl] = int(not has_coeff)
            pred_flags = c.pred_flags
            for lx in (0, 1):
                if pred_flags[lx]:
                    plan.ref_idx[(lx,) + sl] = c.ref_idx[lx]
                    plan.mv[(lx,) + sl] = c.mv[lx]
                    plan.ref_poc[(lx,) + sl] = \
                        self.ref_lists[lx][c.ref_idx[lx]].poc
                else:
                    plan.ref_idx[(lx,) + sl] = -1
                    plan.mv[(lx,) + sl] = 0
        else:
            plan.merge_flag[sl] = 0
            plan.skip_flag[sl] = 0
            for lx in (0, 1):
                if lx in info:
                    mv_l, mvd_l, mvp_f = info[lx]
                    plan.ref_idx[(lx,) + sl] = 0
                    plan.mv[(lx,) + sl] = mv_l
                    plan.ref_poc[(lx,) + sl] = self.ref_lists[lx][0].poc
                    plan.mvd[(lx,) + sl] = mvd_l
                    plan.mvp_flag[(lx,) + sl] = mvp_f
                else:
                    plan.ref_idx[(lx,) + sl] = -1
                    plan.mv[(lx,) + sl] = 0

        plan.tu_log2[sl] = min(log2, sps.max_tb_log2_size_y)
        plan.tu_id[sl] = self.next_id[2]
        self.next_id[2] += 1
        self._mb_adopt(best_est)
        plan.coeff_y[y0:y0 + size, x0:x0 + size] = levels
        plan.coeff_cb[cy:cy + cs, cx:cx + cs] = levels_c[0]
        plan.coeff_cr[cy:cy + cs, cx:cx + cs] = levels_c[1]
        plan.cbf_y[sl] = int(levels.any())
        plan.cbf_cb[sl] = int(levels_c[0].any())
        plan.cbf_cr[sl] = int(levels_c[1].any())
        if log2 - 1 == 2 and self.pps.transform_skip_enabled_flag:
            plan.transform_skip_cb[cy >> 1, cx >> 1] = \
                ts_best[0] if levels_c[0].any() else 0
            plan.transform_skip_cr[cy >> 1, cx >> 1] = \
                ts_best[1] if levels_c[1].any() else 0
        self.recon[0][y0:y0 + size, x0:x0 + size] = rec_y
        self.recon[1][cy:cy + cs, cx:cx + cs] = recs_c[0]
        self.recon[2][cy:cy + cs, cx:cx + cs] = recs_c[1]
        if do_rqt and has_coeff:
            # split can't beat a zero-residual winner (it only adds rate)
            snap_single = self._snapshot(x0, y0, size)
            self._restore(x0, y0, size, st_pre)
            cost_split = self._finish_inter_cu_split_tt(
                x0, y0, log2, candidates, merge_cands, orig_y, orig_cb,
                orig_cr)
            if cost <= cost_split:
                self._restore(x0, y0, size, snap_single)
                return cost
            return cost_split
        return cost
