"""Deblocking filter as torch code on a device: the twin of
decode/deblock_vec.py (port of `turingcodec_tpu/ops/deblock.py`).

Every 4-line edge segment of the picture is one lane of a dense (segments,
edges) batch, with inactive segments masked to passthrough. The written
windows of neighbouring edges tile the sample grid exactly (a vertical
edge at x rewrites columns x-4..x+3; edges are 8 apart), so a direction
pass is reshape -> elementwise filter -> reshape, with no data-dependent
scatter. The horizontal pass reuses the vertical routine on transposed
planes (the filter is symmetric under transposition with p=above ->
p=left).

Bit-exact with the numpy twin and the scalar oracle decode/deblock.py
(reference: turing/LoopFilter.h:425-608).
"""
from __future__ import annotations

import numpy as np
import torch

from turingcodec_tpu_torch.decode.deblock import BETA_TABLE, TC_TABLE
from turingcodec_tpu_torch.hevc.tables import CHROMA_QP_TABLE_420
from turingcodec_tpu_torch.ops.dense_me import edge_pad
from turingcodec_tpu_torch.ops.kernel_build import table


def _motion_bs(ref_idx, ref_poc, mv, byp, bxp, byq, bxq):
    """Motion-difference bS on (S, E) grids (deblock_vec._motion_bs_vec)."""
    i32 = torch.int32
    r0p = ref_idx[0, byp, bxp].to(i32)
    r1p = ref_idx[1, byp, bxp].to(i32)
    r0q = ref_idx[0, byq, bxq].to(i32)
    r1q = ref_idx[1, byq, bxq].to(i32)
    np_cnt = (r0p >= 0).to(i32) + (r1p >= 0)
    nq_cnt = (r0q >= 0).to(i32) + (r1q >= 0)
    poc0p = ref_poc[0, byp, bxp]
    poc1p = ref_poc[1, byp, bxp]
    poc0q = ref_poc[0, byq, bxq]
    poc1q = ref_poc[1, byq, bxq]
    mv0p = mv[0, byp, bxp].to(i32)
    mv1p = mv[1, byp, bxp].to(i32)
    mv0q = mv[0, byq, bxq].to(i32)
    mv1q = mv[1, byq, bxq].to(i32)

    def dge4(a, b):
        return ((a[..., 0] - b[..., 0]).abs() >= 4) | \
               ((a[..., 1] - b[..., 1]).abs() >= 4)

    out = torch.zeros(np_cnt.shape, dtype=i32, device=np_cnt.device)
    out = torch.where(np_cnt != nq_cnt, 1, out)
    same_cnt = np_cnt == nq_cnt

    uni = same_cnt & (np_cnt == 1)
    lp_poc = torch.where(r0p >= 0, poc0p, poc1p)
    lq_poc = torch.where(r0q >= 0, poc0q, poc1q)
    lp_mv = torch.where((r0p >= 0)[..., None], mv0p, mv1p)
    lq_mv = torch.where((r0q >= 0)[..., None], mv0q, mv1q)
    uni_bs = ((lp_poc != lq_poc) | dge4(lp_mv, lq_mv)).to(i32)
    out = torch.where(uni, uni_bs, out)

    bi = same_cnt & (np_cnt == 2)
    set_mismatch = ~(((poc0p == poc0q) & (poc1p == poc1q))
                     | ((poc0p == poc1q) & (poc1p == poc0q)))
    same_pic = poc0p == poc1p
    direct_ok = ~(dge4(mv0p, mv0q) | dge4(mv1p, mv1q))
    crossed_ok = ~(dge4(mv0p, mv1q) | dge4(mv1p, mv0q))
    match_direct = poc0p == poc0q
    distinct_bs = torch.where(match_direct, ~direct_ok, ~crossed_ok)
    bi_bs = torch.where(set_mismatch, True,
                        torch.where(same_pic, ~(direct_ok | crossed_ok),
                                    distinct_bs)).to(i32)
    return torch.where(bi, bi_bs, out)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _dir_pass(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
              across_tiles, chroma):
    """One direction over transposed-or-not planes: 'vertical' edges at
    x in 8Z, 4-line segments. Returns updated (ry, rcb, rcr)."""
    (tu_id, pu_id, cu_id, pred_mode, cbf_y, ref_idx, ref_poc, mv, qp_y,
     slice_idx, tile_id) = maps
    (disabled, across, beta_off_s, tc_off_s, cb_off_s, cr_off_s) = sl
    beta_t, tc_t, cqp_t = (table(a, ry.device) for a in (
        BETA_TABLE, TC_TABLE, CHROMA_QP_TABLE_420))
    dev = ry.device
    i32 = torch.int32
    h, w = ry.shape
    n_e = w // 8 - 1
    n_s = h // 4
    X = (8 * (torch.arange(n_e, device=dev) + 1))[None, :]   # (1, E)
    Y = (4 * torch.arange(n_s, device=dev))[:, None]         # (S, 1)
    bxp = ((X - 1) >> 2).expand(n_s, n_e)
    byp = (Y >> 2).expand(n_s, n_e)
    bxq = (X >> 2).expand(n_s, n_e)
    byq = byp

    edge = ((tu_id[byp, bxp] != tu_id[byq, bxq])
            | (pu_id[byp, bxp] != pu_id[byq, bxq])
            | (cu_id[byp, bxp] != cu_id[byq, bxq]))

    cxq = (X >> ctb_log2).expand(n_s, n_e)
    cxp = ((X - 1) >> ctb_log2).expand(n_s, n_e)
    cyq = (Y >> ctb_log2).expand(n_s, n_e)
    n_sl = disabled.shape[0]
    sl_q = slice_idx[cyq, cxq].long().clamp(0, n_sl - 1)
    edge &= ~disabled[sl_q]
    diff_slice = slice_idx[cyq, cxp] != slice_idx[cyq, cxq]
    edge &= ~(diff_slice & ~across[sl_q])
    if not across_tiles:
        edge &= tile_id[cyq, cxp] == tile_id[cyq, cxq]

    intra_edge = (pred_mode[byp, bxp] == 1) | (pred_mode[byq, bxq] == 1)
    tu_edge = tu_id[byp, bxp] != tu_id[byq, bxq]
    cbf_any = (cbf_y[byp, bxp] > 0) | (cbf_y[byq, bxq] > 0)
    bs = torch.where(intra_edge, 2,
                     torch.where(tu_edge & cbf_any, 1,
                                 _motion_bs(ref_idx, ref_poc, mv,
                                            byp, bxp, byq, bxq)))
    sel = edge & (bs > 0)

    # ---- luma filter on the tiled window view -------------------------
    beta_off = beta_off_s[sl_q]
    tc_off = tc_off_s[sl_q]
    max_val = (1 << bd_y) - 1
    qp_p = qp_y[byp, bxp].to(i32)
    qp_q = qp_y[byq, bxq].to(i32)
    qpl = (qp_p + qp_q + 1) >> 1
    qb = (qpl + beta_off).clamp(0, 51)
    beta = beta_t[qb.long()] << (bd_y - 8)
    qt = (qpl + 2 * (bs - 1) + tc_off).clamp(0, 53)
    tc = tc_t[qt.long()] << (bd_y - 8)

    # windows: ry[:, 4 : 4+8*n_e] -> (S, 4, E, 8) -> (S, E, 4, 8)
    mid = ry[:, 4:4 + 8 * n_e].reshape(n_s, 4, n_e, 8)
    win = mid.permute(0, 2, 1, 3).to(i32)
    p3, p2, p1, p0 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    q0, q1, q2, q3 = win[..., 4], win[..., 5], win[..., 6], win[..., 7]

    dp0 = (p2[..., 0] - 2 * p1[..., 0] + p0[..., 0]).abs()
    dp3 = (p2[..., 3] - 2 * p1[..., 3] + p0[..., 3]).abs()
    dq0 = (q2[..., 0] - 2 * q1[..., 0] + q0[..., 0]).abs()
    dq3 = (q2[..., 3] - 2 * q1[..., 3] + q0[..., 3]).abs()
    d = dp0 + dp3 + dq0 + dq3
    act = sel & (d < beta)

    def dsam(i, dpq):
        return ((2 * dpq < (beta >> 2))
                & ((p3[..., i] - p0[..., i]).abs()
                   + (q0[..., i] - q3[..., i]).abs() < (beta >> 3))
                & ((p0[..., i] - q0[..., i]).abs() < ((5 * tc + 1) >> 1)))

    strong = dsam(0, dp0 + dq0) & dsam(3, dp3 + dq3)

    t2 = (2 * tc)[..., None]
    tcv = tc[..., None]
    sp0 = _clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                p0 - t2, p0 + t2)
    sp1 = _clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2)
    sp2 = _clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                p2 - t2, p2 + t2)
    sq0 = _clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                q0 - t2, q0 + t2)
    sq1 = _clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2)
    sq2 = _clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                q2 - t2, q2 + t2)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = delta.abs() < (tc * 10)[..., None]
    dlt = _clip(delta, -tcv, tcv)
    wp0 = (p0 + dlt).clamp(0, max_val)
    wq0 = (q0 - dlt).clamp(0, max_val)
    d_ep = (dp0 + dp3 < ((beta + (beta >> 1)) >> 3))[..., None]
    d_eq = (dq0 + dq3 < ((beta + (beta >> 1)) >> 3))[..., None]
    tch = (tc >> 1)[..., None]
    dp = _clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tch, tch)
    wq_p1 = (p1 + dp).clamp(0, max_val)
    dq = _clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tch, tch)
    wq_q1 = (q1 + dq).clamp(0, max_val)

    act2 = act[..., None]
    strong2 = strong[..., None]
    where = torch.where
    out_p0 = where(act2, where(strong2, sp0.clamp(0, max_val),
                               where(wmask, wp0, p0)), p0)
    out_p1 = where(act2, where(strong2, sp1.clamp(0, max_val),
                               where(wmask & d_ep, wq_p1, p1)), p1)
    out_p2 = where(act2 & strong2, sp2.clamp(0, max_val), p2)
    out_q0 = where(act2, where(strong2, sq0.clamp(0, max_val),
                               where(wmask, wq0, q0)), q0)
    out_q1 = where(act2, where(strong2, sq1.clamp(0, max_val),
                               where(wmask & d_eq, wq_q1, q1)), q1)
    out_q2 = where(act2 & strong2, sq2.clamp(0, max_val), q2)

    outw = torch.stack([p3, out_p2, out_p1, out_p0,
                        out_q0, out_q1, out_q2, q3], dim=-1)
    mid_out = outw.permute(0, 2, 1, 3).reshape(n_s * 4, n_e * 8)
    ry_out = torch.cat([ry[:, :4], mid_out.to(ry.dtype),
                        ry[:, 4 + 8 * n_e:]], dim=1)

    if not chroma:
        return ry_out, rcb, rcr

    # ---- chroma: bS == 2 on the 16-luma grid --------------------------
    # chroma edges are every second luma edge (x = 16, 32, ..., last < w)
    m = (w - 1) // 16
    if m < 1:
        return ry_out, rcb, rcr
    e_idx = 2 * torch.arange(m, device=dev) + 1   # luma edge index
    cbs = bs[:, e_idx]
    csel = sel[:, e_idx] & (cbs == 2)
    qp_pc = qp_p[:, e_idx]
    qp_qc = qp_q[:, e_idx]
    tc_offc = tc_off[:, e_idx]
    sl_qc = sl_q[:, e_idx]
    max_c = (1 << bd_c) - 1
    w2 = rcb.shape[1]

    def one_plane(plane, off_s):
        off = off_s[sl_qc]
        qp_bd_off_c = 6 * (bd_c - 8)
        qpi = (((qp_pc + qp_qc + 1) >> 1) + off).clamp(-qp_bd_off_c, 57)
        qpc = cqp_t[qpi.clamp(0, 57).long()]
        qpc = torch.where(qpi < 0, qpi, qpc)
        qt_c = (qpc + 2 + tc_offc).clamp(0, 53)
        tc_c = tc_t[qt_c.long()] << (bd_c - 8)
        # window view: plane[:, 6 : 6+8m] -> (S, 2, m, 8), first 4 cols.
        # When w is not a multiple of 16 the last 8-group's unwritten tail
        # extends past the plane edge; pad right by edge replication
        # (never written back).
        pad = max(0, 6 + 8 * m - w2)
        planep = edge_pad(plane, 0, 0, 0, pad) if pad else plane
        midc = planep[:, 6:6 + 8 * m].reshape(n_s, 2, m, 8)
        winc = midc.permute(0, 2, 1, 3).to(i32)
        p1c, p0c = winc[..., 0], winc[..., 1]
        q0c, q1c = winc[..., 2], winc[..., 3]
        tcv_c = tc_c[..., None]
        dl = _clip((((q0c - p0c) << 2) + p1c - q1c + 4) >> 3, -tcv_c, tcv_c)
        np0 = (p0c + dl).clamp(0, max_c)
        nq0 = (q0c - dl).clamp(0, max_c)
        mask = (csel & (tc_c > 0))[..., None]
        o_p0 = torch.where(mask, np0, p0c)
        o_q0 = torch.where(mask, nq0, q0c)
        outc = torch.stack([p1c, o_p0, o_q0, winc[..., 3], winc[..., 4],
                            winc[..., 5], winc[..., 6], winc[..., 7]],
                           dim=-1)
        midc_out = outc.permute(0, 2, 1, 3).reshape(n_s * 2, m * 8)
        out_full = torch.cat([planep[:, :6], midc_out.to(plane.dtype),
                              planep[:, 6 + 8 * m:]], dim=1)
        return out_full[:, :w2]

    return ry_out, one_plane(rcb, cb_off_s), one_plane(rcr, cr_off_s)


def _transpose_maps(maps):
    (tu_id, pu_id, cu_id, pred_mode, cbf_y, ref_idx, ref_poc, mv, qp_y,
     slice_idx, tile_id) = maps
    t = lambda a: a.transpose(-2, -1)  # noqa: E731
    # (2, w4, h4, 2): the mv components stay (x, y), see deblock_device
    return (t(tu_id), t(pu_id), t(cu_id), t(pred_mode), t(cbf_y),
            ref_idx.transpose(1, 2), ref_poc.transpose(1, 2),
            mv.transpose(1, 2), t(qp_y), t(slice_idx), t(tile_id))


def deblock_device(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                   across_tiles):
    """Full deblock (vertical then horizontal) on device tensors; returns
    new contiguous (ry, rcb, rcr).

    mv swap note: mv is (2, h4, w4, 2) with components (x, y); under
    transposition the filter only uses |dx|>=4 | |dy|>=4, which is
    symmetric, so components are NOT swapped."""
    ry, rcb, rcr = _dir_pass(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                             across_tiles, chroma=True)
    ry_t, rcb_t, rcr_t = _dir_pass(
        ry.T, rcb.T, rcr.T, _transpose_maps(maps), sl, ctb_log2, bd_y,
        bd_c, across_tiles, chroma=True)
    return ry_t.T.contiguous(), rcb_t.T.contiguous(), rcr_t.T.contiguous()


def plan_tensors(plan, geom, device):
    """The plan's per-block maps and per-slice parameters on `device`,
    and whether filtering crosses tile boundaries: deblock_device's
    (maps, sl, across_tiles) arguments."""
    pps = plan.pps

    def up(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    maps = tuple(up(a) for a in (
        plan.tu_id, plan.pu_id, plan.cu_id, plan.cu_pred_mode, plan.cbf_y,
        plan.ref_idx, plan.ref_poc, plan.mv, plan.qp_y, plan.slice_idx,
        geom.tile_id))
    shs = plan.slice_headers
    i32 = torch.int32
    sl = (up([bool(sh.slice_deblocking_filter_disabled_flag) for sh in shs]),
          up([bool(sh.slice_loop_filter_across_slices_enabled_flag)
              for sh in shs]),
          up([sh.slice_beta_offset_div2 << 1 for sh in shs], i32),
          up([sh.slice_tc_offset_div2 << 1 for sh in shs], i32),
          up([pps.pps_cb_qp_offset + sh.slice_cb_qp_offset for sh in shs],
             i32),
          up([pps.pps_cr_qp_offset + sh.slice_cr_qp_offset for sh in shs],
             i32))
    across_tiles = (bool(pps.loop_filter_across_tiles_enabled_flag)
                    or geom.num_tiles == 1)
    return maps, sl, across_tiles


def deblock_planes_device(plan, geom, planes):
    """deblock_device over a plan for [y, cb, cr] device tensors (the
    chained pipeline's deblock); returns the new planes as a list."""
    sps = plan.sps
    maps, sl, across_tiles = plan_tensors(plan, geom, planes[0].device)
    return list(deblock_device(
        planes[0], planes[1], planes[2], maps, sl, int(sps.ctb_log2_size_y),
        int(sps.bit_depth_y), int(sps.bit_depth_c), across_tiles))


def deblock_picture_device(plan, geom, ry, rcb, rcr, device):
    """numpy in/out over deblock_device on `device` (drop-in for
    deblock_vec.deblock_picture_vec): writes the host planes in place."""
    out = deblock_planes_device(plan, geom, [
        torch.as_tensor(p, device=device) for p in (ry, rcb, rcr)])
    for host, dev in zip((ry, rcb, rcr), out):
        host[:] = dev.cpu().numpy()
