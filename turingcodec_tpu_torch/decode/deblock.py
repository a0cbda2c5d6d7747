"""Deblocking filter (spec 8.7.2) — numpy reference implementation.

Parity reference: turing/LoopFilter.h:48-608. Operates picture-wide: all
vertical edges first, then all horizontal edges, deriving boundary strengths
from the plan tensors (cu/pu/tu id maps + motion), which makes bS derivation
a vectorizable tensor op for the device twin in ops/deblock.py.
"""
from __future__ import annotations

import numpy as np

from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
from turingcodec_tpu_torch.decode.plan import PicturePlan

BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
                26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54,
                56, 58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3 + [5] * 2 + [6] * 2
    + [7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)


def clip3(lo, hi, v):
    return max(lo, min(hi, v))


def _motion_bs(plan: PicturePlan, byp, bxp, byq, bxq) -> int:
    """bS contribution from motion difference (spec 8.7.2.4 cond 3)."""
    rp = [int(plan.ref_idx[l, byp, bxp]) for l in (0, 1)]
    rq = [int(plan.ref_idx[l, byq, bxq]) for l in (0, 1)]
    np_cnt = sum(r >= 0 for r in rp)
    nq_cnt = sum(r >= 0 for r in rq)
    if np_cnt != nq_cnt:
        return 1
    pocp = [int(plan.ref_poc[l, byp, bxp]) if rp[l] >= 0 else None for l in (0, 1)]
    pocq = [int(plan.ref_poc[l, byq, bxq]) if rq[l] >= 0 else None for l in (0, 1)]
    mvp = [tuple(int(v) for v in plan.mv[l, byp, bxp]) for l in (0, 1)]
    mvq = [tuple(int(v) for v in plan.mv[l, byq, bxq]) for l in (0, 1)]

    def diff_ge4(a, b):
        return abs(a[0] - b[0]) >= 4 or abs(a[1] - b[1]) >= 4

    if np_cnt == 1:
        lp = 0 if rp[0] >= 0 else 1
        lq = 0 if rq[0] >= 0 else 1
        if pocp[lp] != pocq[lq]:
            return 1
        return 1 if diff_ge4(mvp[lp], mvq[lq]) else 0
    if np_cnt == 0:
        return 0
    # both bi-predicted
    set_p = sorted(x for x in pocp if x is not None)
    set_q = sorted(x for x in pocq if x is not None)
    if set_p != set_q:
        return 1
    if pocp[0] == pocp[1]:
        # same picture in both lists: both assignments must fail for bS=1
        direct = not (diff_ge4(mvp[0], mvq[0]) or diff_ge4(mvp[1], mvq[1]))
        crossed = not (diff_ge4(mvp[0], mvq[1]) or diff_ge4(mvp[1], mvq[0]))
        return 0 if (direct or crossed) else 1
    # distinct pictures: match lists by picture
    if pocp[0] == pocq[0]:
        return 1 if (diff_ge4(mvp[0], mvq[0]) or diff_ge4(mvp[1], mvq[1])) else 0
    return 1 if (diff_ge4(mvp[0], mvq[1]) or diff_ge4(mvp[1], mvq[0])) else 0


def deblock_picture(plan: PicturePlan, geom, recon_y, recon_cb, recon_cr):
    """In-place deblocking of the three planes."""
    sps, pps = plan.sps, plan.pps
    for vertical in (True, False):
        _deblock_dir(plan, geom, recon_y, recon_cb, recon_cr, vertical)


def _edge_params(plan: PicturePlan, geom, cx, cy):
    """Per-CTU deblock parameters from its slice header."""
    sh = plan.slice_headers[int(plan.slice_idx[cy, cx])]
    return sh


def _deblock_dir(plan: PicturePlan, geom, ry, rcb, rcr, vertical: bool):
    sps, pps = plan.sps, plan.pps
    h, w = ry.shape
    bd_y = sps.bit_depth_y
    bd_c = sps.bit_depth_c
    max_y = (1 << bd_y) - 1
    max_c = (1 << bd_c) - 1
    ctb_log2 = sps.ctb_log2_size_y

    # iterate 8x8-grid edges; segments of 4 luma samples
    if vertical:
        xs = range(8, w, 8)
    else:
        xs = range(8, h, 8)

    for e in xs:
        seg_range = range(0, h if vertical else w, 4)
        for s in seg_range:
            if vertical:
                x, y = e, s
                bxp, byp = (x - 1) >> 2, y >> 2
                bxq, byq = x >> 2, y >> 2
            else:
                x, y = s, e
                bxp, byp = x >> 2, (y - 1) >> 2
                bxq, byq = x >> 2, y >> 2

            # edge must be a TU or PU boundary
            if (plan.tu_id[byp, bxp] == plan.tu_id[byq, bxq]
                    and plan.pu_id[byp, bxp] == plan.pu_id[byq, bxq]
                    and plan.cu_id[byp, bxp] == plan.cu_id[byq, bxq]):
                continue

            cxq, cyq = x >> ctb_log2, y >> ctb_log2
            sh = plan.slice_headers[int(plan.slice_idx[cyq, cxq])]
            if sh.slice_deblocking_filter_disabled_flag:
                continue
            # slice/tile boundary handling
            cxp = (x - 1) >> ctb_log2 if vertical else cxq
            cyp = cyq if vertical else (y - 1) >> ctb_log2
            if (cxp, cyp) != (cxq, cyq):
                if plan.slice_idx[cyp, cxp] != plan.slice_idx[cyq, cxq]:
                    if not sh.slice_loop_filter_across_slices_enabled_flag:
                        continue
                if geom.tile_id[cyp, cxp] != geom.tile_id[cyq, cxq]:
                    if not pps.loop_filter_across_tiles_enabled_flag:
                        continue

            # boundary strength
            if plan.cu_pred_mode[byp, bxp] == 1 or plan.cu_pred_mode[byq, bxq] == 1:
                bs = 2
            else:
                bs = 0
                if plan.tu_id[byp, bxp] != plan.tu_id[byq, bxq]:
                    if plan.cbf_y[byp, bxp] or plan.cbf_y[byq, bxq]:
                        bs = 1
                if bs == 0:
                    bs = _motion_bs(plan, byp, bxp, byq, bxq)
            if bs == 0:
                continue

            qp_p = int(plan.qp_y[byp, bxp])
            qp_q = int(plan.qp_y[byq, bxq])
            qpl = (qp_p + qp_q + 1) >> 1
            qb = clip3(0, 51, qpl + (sh.slice_beta_offset_div2 << 1))
            beta = int(BETA_TABLE[qb]) << (bd_y - 8)
            qt = clip3(0, 53, qpl + 2 * (bs - 1) + (sh.slice_tc_offset_div2 << 1))
            tc = int(TC_TABLE[qt]) << (bd_y - 8)

            if tc or beta:
                _filter_luma_segment(ry, x, y, vertical, beta, tc, max_y,
                                     plan, byp, bxp, byq, bxq)

            # chroma: bS==2 and 8-sample chroma grid (16 luma)
            if bs == 2 and (e % 16 == 0) and plan.sps.chroma_array_type == 1:
                for c_idx, (plane, off) in enumerate(
                        ((rcb, pps.pps_cb_qp_offset + sh.slice_cb_qp_offset),
                         (rcr, pps.pps_cr_qp_offset + sh.slice_cr_qp_offset))):
                    qpi = ((qp_p + qp_q + 1) >> 1) + off
                    qpc = chroma_qp_from_luma(clip3(-sps.qp_bd_offset_c, 57, qpi))
                    qt = clip3(0, 53, qpc + 2 + (sh.slice_tc_offset_div2 << 1))
                    tcc = int(TC_TABLE[qt]) << (bd_c - 8)
                    if tcc:
                        # 4 luma lines -> 2 chroma lines in 4:2:0
                        _filter_chroma_segment(plane, x >> 1, y >> 1,
                                               vertical, tcc, max_c, 2)


def _filter_luma_segment(r, x, y, vertical, beta, tc, max_val,
                         plan, byp, bxp, byq, bxq):
    """One 4-line luma edge segment (spec 8.7.2.5.3/4/7)."""
    def get(i, k):
        # i: line along edge (0..3), k: sample across edge (-4..3 => p3..q3)
        if vertical:
            return int(r[y + i, x + k])
        return int(r[y + k, x + i])

    def put(i, k, v):
        if vertical:
            r[y + i, x + k] = v
        else:
            r[y + k, x + i] = v

    h, w = r.shape
    if vertical:
        if y + 3 >= h:
            return
    else:
        if x + 3 >= w:
            return

    dp0 = abs(get(0, -3) - 2 * get(0, -2) + get(0, -1))
    dp3 = abs(get(3, -3) - 2 * get(3, -2) + get(3, -1))
    dq0 = abs(get(0, 2) - 2 * get(0, 1) + get(0, 0))
    dq3 = abs(get(3, 2) - 2 * get(3, 1) + get(3, 0))
    d = dp0 + dp3 + dq0 + dq3
    if d >= beta:
        return

    def dsam(i, dpq):
        return (2 * dpq < (beta >> 2)
                and abs(get(i, -4) - get(i, -1)) + abs(get(i, 0) - get(i, 3))
                < (beta >> 3)
                and abs(get(i, -1) - get(i, 0)) < ((5 * tc + 1) >> 1))

    strong = dsam(0, dp0 + dq0) and dsam(3, dp3 + dq3)
    clip = lambda v: clip3(0, max_val, v)

    if strong:
        for i in range(4):
            p3, p2, p1, p0 = get(i, -4), get(i, -3), get(i, -2), get(i, -1)
            q0, q1, q2, q3 = get(i, 0), get(i, 1), get(i, 2), get(i, 3)
            t2 = 2 * tc
            put(i, -1, clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3))
            put(i, -2, clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2))
            put(i, -3, clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3))
            put(i, 0, clip3(q0 - t2, q0 + t2, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3))
            put(i, 1, clip3(q1 - t2, q1 + t2, (p0 + q0 + q1 + q2 + 2) >> 2))
            put(i, 2, clip3(q2 - t2, q2 + t2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3))
    else:
        d_ep = dp0 + dp3 < ((beta + (beta >> 1)) >> 3)
        d_eq = dq0 + dq3 < ((beta + (beta >> 1)) >> 3)
        for i in range(4):
            p2, p1, p0 = get(i, -3), get(i, -2), get(i, -1)
            q0, q1, q2 = get(i, 0), get(i, 1), get(i, 2)
            delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = clip3(-tc, tc, delta)
            put(i, -1, clip(p0 + delta))
            put(i, 0, clip(q0 - delta))
            if d_ep:
                dp = clip3(-(tc >> 1), tc >> 1,
                           (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
                put(i, -2, clip(p1 + dp))
            if d_eq:
                dq = clip3(-(tc >> 1), tc >> 1,
                           (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
                put(i, 1, clip(q1 + dq))


def _filter_chroma_segment(r, x, y, vertical, tc, max_val, n):
    """n-line chroma edge segment (spec 8.7.2.5.5)."""
    h, w = r.shape

    def get(i, k):
        return int(r[y + i, x + k] if vertical else r[y + k, x + i])

    def put(i, k, v):
        if vertical:
            r[y + i, x + k] = v
        else:
            r[y + k, x + i] = v

    if vertical and y + n > h:
        n = h - y
    if not vertical and x + n > w:
        n = w - x
    for i in range(n):
        p1, p0, q0, q1 = get(i, -2), get(i, -1), get(i, 0), get(i, 1)
        delta = clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
        put(i, -1, clip3(0, max_val, p0 + delta))
        put(i, 0, clip3(0, max_val, q0 - delta))
