"""Plain numpy reference of the decoder's device pipeline stages: motion
compensation with the uni/bi combine, dequantisation and inverse transform
of the inter residuals, deblocking, and SAO.

Frozen copies, from commit dd78b9c, of the port's host versions, their
native fast paths left out:
- pu_geometry, _gather_windows, _interp_group, the numpy body of
  reconstruct_inter_batch (inter_reconstruct here) and
  _inter_residuals_batch: decode/recon_vec.py;
- deblock and its helpers: decode/deblock_vec.py; BETA_TABLE, TC_TABLE:
  decode/deblock.py (HEVC Tables 8-12 beta', 8-12 tC');
- sao and its helpers: decode/sao.py;
- LUMA_FILTER, CHROMA_FILTER, LEVEL_SCALE, dct2_matrix,
  chroma_qp_from_luma, CHROMA_QP_TABLE_420: hevc/tables.py (HEVC 8.6.1,
  8.6.4.2, Tables 8-10, 8-11, 8-12); the PART_* codes: hevc/types.py.

It imports nothing of the port. It reads the picture's parse (the
decoder's PicturePlan: the per-block tensors, the CU and TU records, the
coefficient planes and the slice headers) and the picture's tile map as
data: the stages it recomputes follow that parse, which no plain code
here redoes. Every function is integer arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np

PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN = 0, 1, 2, 3
PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N = 4, 5, 6, 7

LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)
_CHROMA_QP_30_43 = np.array(
    [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37], dtype=np.int32)


def chroma_qp_from_luma(qp_i: int) -> int:
    """qPi -> QpC for 4:2:0 (8.6.1, Table 8-10)."""
    qp_i = int(qp_i)
    if qp_i < 30:
        return qp_i
    if qp_i > 43:
        return qp_i - 6
    return int(_CHROMA_QP_30_43[qp_i - 30])


CHROMA_QP_TABLE_420 = np.array(
    [chroma_qp_from_luma(q) for q in range(58)], dtype=np.int32)

_DCT_C = np.array([
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0,
], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """HEVC core transform matrix (8.6.4.2), n in {4, 8, 16, 32}."""
    m = np.zeros((n, n), dtype=np.int64)
    step = 32 // n
    for i in range(n):
        for j in range(n):
            k = (i * step * (2 * j + 1)) % 128
            sign = 1
            if k > 64:
                k = 128 - k
            if k > 32:
                k = 64 - k
                sign = -1
            m[i, j] = sign * _DCT_C[k]
    return m


LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)
CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)
BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
                26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54,
                56, 58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3 + [5] * 2 + [6] * 2
    + [7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)


# ------------------------------------------------------------ the parse

class Cu:
    __slots__ = ("x0", "y0", "log2_size", "pred_mode", "part_mode", "skip",
                 "tq_bypass", "tus")

    def __init__(self, x0, y0, log2, pred, pm, skip, tqb, tus):
        self.x0, self.y0, self.log2_size = x0, y0, log2
        self.pred_mode, self.part_mode = pred, pm
        self.skip, self.tq_bypass, self.tus = bool(skip), bool(tqb), tus


def coding_units(plan) -> list:
    """The picture's CUs in decode order, each with its TU records
    (x0, y0, log2, blk_idx, x_base, y_base, cbf_y, cbf_cb, cbf_cr): from
    the native parser's raw (n, 8) CU and (m, 9) TU record arrays where the
    plan holds them, else from its CU objects."""
    parts = getattr(plan.cu_list, "parts", None)
    out = []
    if parts:
        for cu_arr, tu_arr in parts:
            tus = [tuple(t) for t in np.asarray(tu_arr).tolist()]
            ti = 0
            for (x0, y0, log2, pred, pm, skip, tqb, ntus) in \
                    np.asarray(cu_arr).tolist():
                out.append(Cu(x0, y0, log2, pred, pm, skip, tqb,
                              tus[ti:ti + ntus]))
                ti += ntus
        return out
    for cu in list.__iter__(plan.cu_list):
        out.append(Cu(cu.x0, cu.y0, cu.log2_size, cu.pred_mode,
                      cu.part_mode, cu.skip, cu.tq_bypass, list(cu.tus)))
    return out


# ------------------------------------------------------------ inter

def pu_geometry(cu):
    x0, y0 = cu.x0, cu.y0
    s = 1 << cu.log2_size
    h = s >> 1
    q = s >> 2
    return {
        PART_2Nx2N: [(x0, y0, s, s)],
        PART_2NxN: [(x0, y0, s, h), (x0, y0 + h, s, h)],
        PART_Nx2N: [(x0, y0, h, s), (x0 + h, y0, h, s)],
        PART_NxN: [(x0, y0, h, h), (x0 + h, y0, h, h),
                   (x0, y0 + h, h, h), (x0 + h, y0 + h, h, h)],
        PART_2NxnU: [(x0, y0, s, q), (x0, y0 + q, s, s - q)],
        PART_2NxnD: [(x0, y0, s, s - q), (x0, y0 + s - q, s, q)],
        PART_nLx2N: [(x0, y0, q, s), (x0 + q, y0, s - q, s)],
        PART_nRx2N: [(x0, y0, s - q, s), (x0 + s - q, y0, q, s)],
    }[cu.part_mode]


def _gather_windows(ref, xs, ys, w, h, pad):
    """(B, h+pad-1, w+pad-1) windows at (xs, ys) with edge clamp."""
    hh, ww = ref.shape
    ry = np.clip(ys[:, None] + np.arange(h + pad - 1)[None, :], 0, hh - 1)
    rx = np.clip(xs[:, None] + np.arange(w + pad - 1)[None, :], 0, ww - 1)
    return ref[ry[:, :, None], rx[:, None, :]].astype(np.int32)


def _interp_group(ref, xs_int, ys_int, xf, yf, w, h, bit_depth, taps, filt):
    """Fractional interpolation of blocks of one size from one plane, each
    with its own phase (8.5.3.3.3): (B, h, w) 14-bit predictions."""
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    off = taps // 2 - 1
    win = _gather_windows(ref, xs_int - off, ys_int - off, w, h, taps)
    fh = filt[xf]
    fv = filt[yf]
    b = win.shape[0]
    tmp = fh[:, 0, None, None] * win[:, :, 0:w]
    for k in range(1, taps):
        tmp += fh[:, k, None, None] * win[:, :, k:k + w]
    tmp >>= shift1
    out = np.zeros((b, h, w), np.int64)
    for k in range(taps):
        out += fv[:, k, None, None] * tmp[:, k:k + h, :]
    out >>= shift2
    h_only = tmp[:, off:off + h, :]
    wc = win[:, :, off:off + w]
    v_only = fv[:, 0, None, None] * wc[:, 0:h, :]
    for k in range(1, taps):
        v_only = v_only + fv[:, k, None, None] * wc[:, k:k + h, :]
    v_only >>= shift1
    center = win[:, off:off + h, off:off + w].astype(np.int64) << shift3
    out = np.where((yf == 0)[:, None, None], h_only, out)
    out = np.where(((xf == 0) & (yf != 0))[:, None, None], v_only, out)
    out = np.where(((xf == 0) & (yf == 0))[:, None, None], center, out)
    return out


def inter_reconstruct(plan, refs, recon) -> None:
    """MC and the residuals of every inter CU, written into the [y, cb, cr]
    planes `recon` in place. refs[lx][r] is the (y, cb, cr) host planes of
    reference r of list lx."""
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    max_y, max_c = (1 << bd_y) - 1, (1 << bd_c) - 1
    pus = []
    inter_cus = []
    for cu in coding_units(plan):
        if cu.pred_mode != 0:
            continue
        inter_cus.append(cu)
        for (px, py, pw, ph) in pu_geometry(cu):
            bx, by = px >> 2, py >> 2
            info = []
            for lx in (0, 1):
                r = int(plan.ref_idx[lx, by, bx])
                info.append((r, int(plan.mv[lx, by, bx, 0]),
                             int(plan.mv[lx, by, bx, 1])) if r >= 0 else None)
            pus.append((px, py, pw, ph, info))
    if not pus:
        return
    groups = {}
    for i, (px, py, pw, ph, info) in enumerate(pus):
        for lx in (0, 1):
            if info[lx] is None:
                continue
            r, mvx, mvy = info[lx]
            groups.setdefault((pw, ph, lx, r), []).append(
                (i, lx, px + (mvx >> 2), py + (mvy >> 2), mvx & 3, mvy & 3,
                 (px >> 1) + (mvx >> 3), (py >> 1) + (mvy >> 3),
                 mvx & 7, mvy & 7))
    pred14 = [[None, None] for _ in pus]
    pred14c = [[None, None] for _ in pus]
    for (pw, ph, lx, r), items in groups.items():
        ref = refs[lx][r]
        col = [np.array([t[k] for t in items]) for k in range(10)]
        py_ = _interp_group(ref[0], col[2], col[3], col[4], col[5], pw, ph,
                            bd_y, 8, LUMA_FILTER)
        pcb = _interp_group(ref[1], col[6], col[7], col[8], col[9], pw >> 1,
                            ph >> 1, bd_c, 4, CHROMA_FILTER)
        pcr = _interp_group(ref[2], col[6], col[7], col[8], col[9], pw >> 1,
                            ph >> 1, bd_c, 4, CHROMA_FILTER)
        for k, i in enumerate(col[0]):
            pred14[i][lx] = py_[k]
            pred14c[i][lx] = (pcb[k], pcr[k])
    ry, rcb, rcr = recon
    for i, (px, py, pw, ph, info) in enumerate(pus):
        for (plane, max_v, bd, parts) in (
                (ry, max_y, bd_y, pred14[i]),
                (rcb, max_c, bd_c,
                 [p[0] if p else None for p in pred14c[i]]),
                (rcr, max_c, bd_c,
                 [p[1] if p else None for p in pred14c[i]])):
            shift = 14 - bd
            ps_ = [p for p in parts if p is not None]
            if len(ps_) == 2:
                v = (ps_[0] + ps_[1] + (1 << shift)) >> (shift + 1)
            else:
                v = (ps_[0] + (1 << (shift - 1))) >> shift
            v = np.clip(v, 0, max_v)
            if plane is ry:
                plane[py:py + ph, px:px + pw] = v
            else:
                plane[py >> 1:(py + ph) >> 1, px >> 1:(px + pw) >> 1] = v
    _inter_residuals(plan, inter_cus, recon)


def _inter_residuals(plan, inter_cus, recon):
    """Dequantisation (8.6.3), inverse transform or transform skip (8.6.4)
    and the add and clip of every coded inter TU."""
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    groups = {}
    for cu in inter_cus:
        if cu.skip or not cu.tus:
            continue
        bx, by = cu.x0 >> 2, cu.y0 >> 2
        qp_y = int(plan.qp_y[by, bx]) + sps.qp_bd_offset_y
        sh = plan.slice_headers[int(
            plan.slice_idx[cu.y0 >> sps.ctb_log2_size_y,
                           cu.x0 >> sps.ctb_log2_size_y])]
        qp_cb = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c,
                min(57, int(plan.qp_y[by, bx]) + plan.pps.pps_cb_qp_offset
                    + sh.slice_cb_qp_offset))) + sps.qp_bd_offset_c
        qp_cr = chroma_qp_from_luma(
            max(-sps.qp_bd_offset_c,
                min(57, int(plan.qp_y[by, bx]) + plan.pps.pps_cr_qp_offset
                    + sh.slice_cr_qp_offset))) + sps.qp_bd_offset_c
        for (x0, y0, log2, blk_idx, xb, yb, cbf_y, cbf_cb, cbf_cr) in cu.tus:
            ts = plan.transform_skip_y[y0 >> 2, x0 >> 2]
            if cbf_y:
                groups.setdefault(("y", log2, bool(ts), cu.tq_bypass),
                                  []).append((x0, y0, qp_y))
            if log2 > 2:
                cx, cy, cl = x0 >> 1, y0 >> 1, log2 - 1
            elif blk_idx == 3:
                cx, cy, cl = xb >> 1, yb >> 1, 2
            else:
                continue
            if cbf_cb:
                tsc = plan.transform_skip_cb[cy >> 1, cx >> 1]
                groups.setdefault(("cb", cl, bool(tsc), cu.tq_bypass),
                                  []).append((cx, cy, qp_cb))
            if cbf_cr:
                tsc = plan.transform_skip_cr[cy >> 1, cx >> 1]
                groups.setdefault(("cr", cl, bool(tsc), cu.tq_bypass),
                                  []).append((cx, cy, qp_cr))
    ry, rcb, rcr = recon
    planes = {"y": (plan.coeff_y, ry, bd_y),
              "cb": (plan.coeff_cb, rcb, bd_c),
              "cr": (plan.coeff_cr, rcr, bd_c)}
    for (comp, log2, ts, bypass), items in groups.items():
        coeffp, rplane, bd = planes[comp]
        n = 1 << log2
        max_v = (1 << bd) - 1
        xs = np.array([t[0] for t in items])
        ys = np.array([t[1] for t in items])
        qps = np.array([t[2] for t in items])
        blocks = np.stack([coeffp[y:y + n, x:x + n]
                           for x, y in zip(xs, ys)]).astype(np.int64)
        if bypass:
            res = blocks.astype(np.int32)
        else:
            bd_shift = bd + log2 - 5
            ls = (LEVEL_SCALE[qps % 6].astype(np.int64) << (qps // 6)) * 16
            d = (blocks * ls[:, None, None] + (1 << (bd_shift - 1))) \
                >> bd_shift
            d = np.clip(d, -32768, 32767)
            bds2 = 20 - bd
            if ts:
                res = np.clip(((d << 7) + (1 << (bds2 - 1))) >> bds2,
                              -32768, 32767).astype(np.int32)
            else:
                m = dct2_matrix(n)
                e = np.matmul(m.T, d)
                g = np.clip((e + 64) >> 7, -32768, 32767)
                r = np.matmul(g, m)
                res = np.clip((r + (1 << (bds2 - 1))) >> bds2,
                              -32768, 32767).astype(np.int32)
        for k, (x, y) in enumerate(zip(xs, ys)):
            blk = rplane[y:y + n, x:x + n].astype(np.int32) + res[k]
            rplane[y:y + n, x:x + n] = np.clip(blk, 0, max_v)


# ------------------------------------------------------------ deblocking

def deblock(plan, geom, ry, rcb, rcr) -> None:
    """The deblocking filter (8.7.2), vertical edges then horizontal, on
    the planes in place."""
    for vertical in (True, False):
        _deblock_dir(plan, geom, ry, rcb, rcr, vertical)


def _motion_bs(plan, byp, bxp, byq, bxq):
    """bS from the motion of the two sides (8.7.2.4)."""
    r0p = plan.ref_idx[0, byp, bxp].astype(np.int32)
    r1p = plan.ref_idx[1, byp, bxp].astype(np.int32)
    r0q = plan.ref_idx[0, byq, bxq].astype(np.int32)
    r1q = plan.ref_idx[1, byq, bxq].astype(np.int32)
    np_cnt = (r0p >= 0).astype(np.int32) + (r1p >= 0)
    nq_cnt = (r0q >= 0).astype(np.int32) + (r1q >= 0)
    poc0p = plan.ref_poc[0, byp, bxp]
    poc1p = plan.ref_poc[1, byp, bxp]
    poc0q = plan.ref_poc[0, byq, bxq]
    poc1q = plan.ref_poc[1, byq, bxq]
    mv0p = plan.mv[0, byp, bxp].astype(np.int32)
    mv1p = plan.mv[1, byp, bxp].astype(np.int32)
    mv0q = plan.mv[0, byq, bxq].astype(np.int32)
    mv1q = plan.mv[1, byq, bxq].astype(np.int32)

    def dge4(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
               (np.abs(a[..., 1] - b[..., 1]) >= 4)

    out = np.zeros(byp.shape, np.int32)
    out = np.where(np_cnt != nq_cnt, 1, out)
    same_cnt = np_cnt == nq_cnt
    uni = same_cnt & (np_cnt == 1)
    lp_poc = np.where(r0p >= 0, poc0p, poc1p)
    lq_poc = np.where(r0q >= 0, poc0q, poc1q)
    lp_mv = np.where((r0p >= 0)[..., None], mv0p, mv1p)
    lq_mv = np.where((r0q >= 0)[..., None], mv0q, mv1q)
    uni_bs = ((lp_poc != lq_poc) | dge4(lp_mv, lq_mv)).astype(np.int32)
    out = np.where(uni, uni_bs, out)
    bi = same_cnt & (np_cnt == 2)
    set_mismatch = ~(((poc0p == poc0q) & (poc1p == poc1q))
                     | ((poc0p == poc1q) & (poc1p == poc0q)))
    same_pic = poc0p == poc1p
    direct_ok = ~(dge4(mv0p, mv0q) | dge4(mv1p, mv1q))
    crossed_ok = ~(dge4(mv0p, mv1q) | dge4(mv1p, mv0q))
    match_direct = poc0p == poc0q
    distinct_bs = np.where(match_direct, ~direct_ok, ~crossed_ok)
    bi_bs = np.where(set_mismatch, True,
                     np.where(same_pic, ~(direct_ok | crossed_ok),
                              distinct_bs)).astype(np.int32)
    return np.where(bi, bi_bs, out)


def _deblock_dir(plan, geom, ry, rcb, rcr, vertical: bool):
    sps, pps = plan.sps, plan.pps
    h, w = ry.shape
    ctb_log2 = sps.ctb_log2_size_y
    if vertical:
        X, Y = np.meshgrid(np.arange(8, w, 8), np.arange(0, h, 4))
    else:
        X, Y = np.meshgrid(np.arange(0, w, 4), np.arange(8, h, 8))
    X = X.ravel()
    Y = Y.ravel()
    if vertical:
        bxp, byp = (X - 1) >> 2, Y >> 2
    else:
        bxp, byp = X >> 2, (Y - 1) >> 2
    bxq, byq = X >> 2, Y >> 2
    edge = ((plan.tu_id[byp, bxp] != plan.tu_id[byq, bxq])
            | (plan.pu_id[byp, bxp] != plan.pu_id[byq, bxq])
            | (plan.cu_id[byp, bxp] != plan.cu_id[byq, bxq]))
    cxq, cyq = X >> ctb_log2, Y >> ctb_log2
    n_sl = len(plan.slice_headers)
    disabled = np.array([sh.slice_deblocking_filter_disabled_flag
                         for sh in plan.slice_headers], bool)
    across = np.array([sh.slice_loop_filter_across_slices_enabled_flag
                       for sh in plan.slice_headers], bool)
    beta_off = np.array([sh.slice_beta_offset_div2 << 1
                         for sh in plan.slice_headers], np.int32)
    tc_off = np.array([sh.slice_tc_offset_div2 << 1
                       for sh in plan.slice_headers], np.int32)
    sl_q = np.clip(plan.slice_idx[cyq, cxq], 0, n_sl - 1)
    edge &= ~disabled[sl_q]
    if vertical:
        cxp, cyp = (X - 1) >> ctb_log2, cyq
    else:
        cxp, cyp = cxq, (Y - 1) >> ctb_log2
    diff_slice = plan.slice_idx[cyp, cxp] != plan.slice_idx[cyq, cxq]
    edge &= ~(diff_slice & ~across[sl_q])
    if geom.num_tiles > 1:
        diff_tile = geom.tile_id[cyp, cxp] != geom.tile_id[cyq, cxq]
        edge &= ~(diff_tile
                  & ~bool(pps.loop_filter_across_tiles_enabled_flag))
    intra_edge = (plan.cu_pred_mode[byp, bxp] == 1) | \
                 (plan.cu_pred_mode[byq, bxq] == 1)
    tu_edge = plan.tu_id[byp, bxp] != plan.tu_id[byq, bxq]
    cbf_any = (plan.cbf_y[byp, bxp] > 0) | (plan.cbf_y[byq, bxq] > 0)
    bs = np.where(intra_edge, 2,
                  np.where(tu_edge & cbf_any, 1,
                           _motion_bs(plan, byp, bxp, byq, bxq)))
    sel = edge & (bs > 0)
    if vertical:
        sel &= Y + 3 < h
    else:
        sel &= X + 3 < w
    idx = np.nonzero(sel)[0]
    if idx.size:
        _filter_luma(plan, ry, X[idx], Y[idx], bs[idx], byp[idx], bxp[idx],
                     byq[idx], bxq[idx], beta_off[sl_q[idx]],
                     tc_off[sl_q[idx]], vertical, sps.bit_depth_y)
    if sps.chroma_array_type == 1:
        csel = edge & (bs == 2) & ((X if vertical else Y) % 16 == 0)
        cidx = np.nonzero(csel)[0]
        if cidx.size:
            _filter_chroma(plan, rcb, rcr, X[cidx], Y[cidx], byp[cidx],
                           bxp[cidx], byq[cidx], bxq[cidx],
                           tc_off[sl_q[cidx]], vertical)


def _filter_luma(plan, r, X, Y, bs, byp, bxp, byq, bxq, beta_off, tc_off,
                 vertical, bd):
    max_val = (1 << bd) - 1
    qp_p = plan.qp_y[byp, bxp].astype(np.int32)
    qp_q = plan.qp_y[byq, bxq].astype(np.int32)
    qpl = (qp_p + qp_q + 1) >> 1
    beta = BETA_TABLE[np.clip(qpl + beta_off, 0, 51)] << (bd - 8)
    tc = TC_TABLE[np.clip(qpl + 2 * (bs - 1) + tc_off, 0, 53)] << (bd - 8)
    di = np.arange(4)
    dk = np.arange(-4, 4)
    if vertical:
        rows = Y[:, None, None] + di[None, :, None]
        cols = X[:, None, None] + dk[None, None, :]
    else:
        rows = Y[:, None, None] + dk[None, None, :]
        cols = X[:, None, None] + di[None, :, None]
    win = r[rows, cols].astype(np.int32)
    p3, p2, p1, p0 = win[:, :, 0], win[:, :, 1], win[:, :, 2], win[:, :, 3]
    q0, q1, q2, q3 = win[:, :, 4], win[:, :, 5], win[:, :, 6], win[:, :, 7]
    dp0 = np.abs(p2[:, 0] - 2 * p1[:, 0] + p0[:, 0])
    dp3 = np.abs(p2[:, 3] - 2 * p1[:, 3] + p0[:, 3])
    dq0 = np.abs(q2[:, 0] - 2 * q1[:, 0] + q0[:, 0])
    dq3 = np.abs(q2[:, 3] - 2 * q1[:, 3] + q0[:, 3])
    act = dp0 + dp3 + dq0 + dq3 < beta
    if not act.any():
        return

    def dsam(i, dpq):
        return ((2 * dpq < (beta >> 2))
                & (np.abs(p3[:, i] - p0[:, i]) + np.abs(q0[:, i] - q3[:, i])
                   < (beta >> 3))
                & (np.abs(p0[:, i] - q0[:, i]) < ((5 * tc + 1) >> 1)))

    strong = dsam(0, dp0 + dq0) & dsam(3, dp3 + dq3)
    t2 = (2 * tc)[:, None]
    tcv = tc[:, None]
    sp0 = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                  p0 - t2, p0 + t2)
    sp1 = np.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2)
    sp2 = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - t2,
                  p2 + t2)
    sq0 = np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                  q0 - t2, q0 + t2)
    sq1 = np.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2)
    sq2 = np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - t2,
                  q2 + t2)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = np.abs(delta) < (tc * 10)[:, None]
    dlt = np.clip(delta, -tcv, tcv)
    wp0 = np.clip(p0 + dlt, 0, max_val)
    wq0 = np.clip(q0 - dlt, 0, max_val)
    d_ep = (dp0 + dp3 < ((beta + (beta >> 1)) >> 3))[:, None]
    d_eq = (dq0 + dq3 < ((beta + (beta >> 1)) >> 3))[:, None]
    tch = (tc >> 1)[:, None]
    dp = np.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tch, tch)
    wp1 = np.clip(p1 + dp, 0, max_val)
    dq = np.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tch, tch)
    wq1 = np.clip(q1 + dq, 0, max_val)
    act2 = act[:, None]
    strong2 = strong[:, None]
    outw = win.copy()
    outw[:, :, 1] = np.where(act2 & strong2, np.clip(sp2, 0, max_val), p2)
    outw[:, :, 2] = np.where(act2, np.where(
        strong2, np.clip(sp1, 0, max_val),
        np.where(wmask & d_ep, wp1, p1)), p1)
    outw[:, :, 3] = np.where(act2, np.where(
        strong2, np.clip(sp0, 0, max_val), np.where(wmask, wp0, p0)), p0)
    outw[:, :, 4] = np.where(act2, np.where(
        strong2, np.clip(sq0, 0, max_val), np.where(wmask, wq0, q0)), q0)
    outw[:, :, 5] = np.where(act2, np.where(
        strong2, np.clip(sq1, 0, max_val),
        np.where(wmask & d_eq, wq1, q1)), q1)
    outw[:, :, 6] = np.where(act2 & strong2, np.clip(sq2, 0, max_val), q2)
    r[rows, cols] = outw.astype(r.dtype)


def _filter_chroma(plan, rcb, rcr, X, Y, byp, bxp, byq, bxq, tc_off,
                   vertical):
    sps, pps = plan.sps, plan.pps
    bd_c = sps.bit_depth_c
    max_val = (1 << bd_c) - 1
    qp_p = plan.qp_y[byp, bxp].astype(np.int32)
    qp_q = plan.qp_y[byq, bxq].astype(np.int32)
    n_sl = len(plan.slice_headers)
    ctb_log2 = sps.ctb_log2_size_y
    sl_q = np.clip(plan.slice_idx[Y >> ctb_log2, X >> ctb_log2], 0,
                   n_sl - 1)
    cb_off = np.array([pps.pps_cb_qp_offset + sh.slice_cb_qp_offset
                       for sh in plan.slice_headers], np.int32)[sl_q]
    cr_off = np.array([pps.pps_cr_qp_offset + sh.slice_cr_qp_offset
                       for sh in plan.slice_headers], np.int32)[sl_q]
    h2, w2 = rcb.shape
    for plane, off in ((rcb, cb_off), (rcr, cr_off)):
        qpi = np.clip(((qp_p + qp_q + 1) >> 1) + off, -sps.qp_bd_offset_c,
                      57)
        qpc = CHROMA_QP_TABLE_420[np.clip(qpi, 0, 57)]
        qpc = np.where(qpi < 0, qpi, qpc)
        tc = TC_TABLE[np.clip(qpc + 2 + tc_off, 0, 53)] << (bd_c - 8)
        cx, cy = X >> 1, Y >> 1
        di = np.arange(2)
        dk = np.arange(-2, 2)
        if vertical:
            rows = np.minimum(cy[:, None, None] + di[None, :, None], h2 - 1)
            cols = cx[:, None, None] + dk[None, None, :]
        else:
            rows = cy[:, None, None] + dk[None, None, :]
            cols = np.minimum(cx[:, None, None] + di[None, :, None], w2 - 1)
        win = plane[rows, cols].astype(np.int32)
        p1, p0, q0, q1 = win[:, :, 0], win[:, :, 1], win[:, :, 2], \
            win[:, :, 3]
        tcv = tc[:, None]
        delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tcv, tcv)
        mask = (tc > 0)[:, None]
        outw = win.copy()
        outw[:, :, 1] = np.where(mask, np.clip(p0 + delta, 0, max_val), p0)
        outw[:, :, 2] = np.where(mask, np.clip(q0 - delta, 0, max_val), q0)
        plane[rows, cols] = outw.astype(plane.dtype)


# ------------------------------------------------------------ SAO

_EO_NEIGHBOURS = {
    0: ((0, -1), (0, 1)),
    1: ((-1, 0), (1, 0)),
    2: ((-1, -1), (1, 1)),
    3: ((-1, 1), (1, -1)),
}


def sao(plan, geom, deblocked) -> list:
    """SAO (8.7.3) of the deblocked [y, cb, cr] planes: new planes."""
    sps = plan.sps
    out = [p.copy() for p in deblocked]
    for cy in range(sps.pic_height_in_ctbs_y):
        for cx in range(sps.pic_width_in_ctbs_y):
            sidx = int(plan.slice_idx[cy, cx])
            if sidx < 0:
                continue
            sh = plan.slice_headers[sidx]
            for c_idx in range(3 if sps.chroma_array_type else 1):
                t = int(plan.sao_type[cy, cx, c_idx])
                if t == 0:
                    continue
                if c_idx == 0 and not sh.slice_sao_luma_flag:
                    continue
                if c_idx > 0 and not sh.slice_sao_chroma_flag:
                    continue
                _sao_ctb(plan, geom, deblocked[c_idx], out[c_idx], cx, cy,
                         c_idx, t)
    return out


def _sao_ctb(plan, geom, src, dst, cx, cy, c_idx, sao_type):
    sps, pps = plan.sps, plan.pps
    bd = sps.bit_depth_y if c_idx == 0 else sps.bit_depth_c
    max_val = (1 << bd) - 1
    sub = 1 if c_idx == 0 else 2
    ctb = sps.ctb_size_y // sub
    h, w = src.shape
    x0, y0 = cx * ctb, cy * ctb
    x1, y1 = min(x0 + ctb, w), min(y0 + ctb, h)
    offsets = plan.sao_offsets[cy, cx, c_idx].astype(np.int32)
    block = src[y0:y1, x0:x1].astype(np.int32)
    skip = None
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        skip = plan.pcm_flag
    if pps.transquant_bypass_enabled_flag:
        skip = plan.tq_bypass if skip is None else \
            (plan.tq_bypass | plan.pcm_flag)
    if sao_type == 1:
        band_pos = int(plan.sao_class[cy, cx, c_idx])
        band_of = block >> (bd - 5)
        res = block.copy()
        for k in range(4):
            res = np.where(band_of == ((band_pos + k) & 31),
                           block + offsets[k], res)
        res = np.clip(res, 0, max_val)
    else:
        (ady, adx), (bdy, bdx) = _EO_NEIGHBOURS[int(
            plan.sao_class[cy, cx, c_idx])]
        ys, xs = np.mgrid[y0:y1, x0:x1]
        ay, ax = ys + ady, xs + adx
        by_, bx_ = ys + bdy, xs + bdx
        valid = (ay >= 0) & (ay < h) & (ax >= 0) & (ax < w) & \
                (by_ >= 0) & (by_ < h) & (bx_ >= 0) & (bx_ < w)
        valid &= _neighbour_ok(plan, geom, ys * sub, xs * sub, ay * sub,
                               ax * sub)
        valid &= _neighbour_ok(plan, geom, ys * sub, xs * sub, by_ * sub,
                               bx_ * sub)
        a_vals = src[np.clip(ay, 0, h - 1),
                     np.clip(ax, 0, w - 1)].astype(np.int32)
        b_vals = src[np.clip(by_, 0, h - 1),
                     np.clip(bx_, 0, w - 1)].astype(np.int32)
        edge_idx = 2 + np.sign(block - a_vals) + np.sign(block - b_vals)
        edge_idx = np.array([1, 2, 0, 3, 4], dtype=np.int32)[edge_idx]
        off_lut = np.array([0, offsets[0], offsets[1], offsets[2],
                            offsets[3]], dtype=np.int32)
        res = np.where(valid, np.clip(block + off_lut[edge_idx], 0,
                                      max_val), block)
    if skip is not None:
        sk = skip[(y0 * sub) >> 2:(y1 * sub) >> 2,
                  (x0 * sub) >> 2:(x1 * sub) >> 2]
        sk_full = np.kron(sk, np.ones((4 // sub, 4 // sub), dtype=bool))
        res = np.where(sk_full[:res.shape[0], :res.shape[1]], block, res)
    dst[y0:y1, x0:x1] = res


def _neighbour_ok(plan, geom, y_l, x_l, yn_l, xn_l):
    """Whether an SAO edge neighbour may be used across slice and tile
    boundaries (8.7.3; the current slice's flag, exact for one slice a
    picture)."""
    sps = plan.sps
    yn = np.clip(yn_l, 0, sps.pic_height_in_luma_samples - 1)
    xn = np.clip(xn_l, 0, sps.pic_width_in_luma_samples - 1)
    cl2 = sps.ctb_log2_size_y
    cur_slice = plan.slice_idx[y_l >> cl2, x_l >> cl2]
    nb_slice = plan.slice_idx[yn >> cl2, xn >> cl2]
    ok = np.ones(cur_slice.shape, dtype=bool)
    if not plan.pps.loop_filter_across_tiles_enabled_flag:
        ok &= geom.tile_id[y_l >> cl2, x_l >> cl2] == \
            geom.tile_id[yn >> cl2, xn >> cl2]
    flags = np.array([sh.slice_loop_filter_across_slices_enabled_flag
                      for sh in plan.slice_headers], dtype=bool)
    allowed = np.where(cur_slice >= 0,
                       flags[np.clip(cur_slice, 0, len(flags) - 1)], True)
    return ok & ((cur_slice == nb_slice) | allowed)


# ------------------------------------------------------------ a picture

def loop_filtered(plan, geom, pre) -> list:
    """Deblocking, then SAO where a slice turns it on, of the
    pre-loop-filter planes `pre` (not changed): new planes."""
    rec = [np.array(p, np.int16) for p in pre]
    deblock(plan, geom, *rec)
    if any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
           for sh in plan.slice_headers):
        rec = sao(plan, geom, rec)
    return rec


def check_picture(plan, geom, refs, pre, out) -> tuple:
    """(inter, filtered): the samples where the pipeline's pre-loop-filter
    planes `pre` differ from this MC and residual stage over the inter
    CUs, and where its output `out` differs from this deblocking and SAO
    of the same planes with the inter CUs recomputed. The intra CUs' samples
    are the pipeline's own (its host intra), taken as they are."""
    rec = [np.array(p, np.int16) for p in pre]
    inter_reconstruct(plan, refs, rec)
    inter = sum(int((a != np.asarray(b)).sum()) for a, b in zip(rec, pre))
    final = loop_filtered(plan, geom, rec)
    filtered = sum(int((a != np.asarray(b)).sum())
                   for a, b in zip(final, out))
    return inter, filtered
