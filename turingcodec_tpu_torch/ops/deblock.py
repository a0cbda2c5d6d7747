"""Deblocking filter on a device: the twin of decode/deblock_vec.py (port
of `turingcodec_tpu/ops/deblock.py`).

`deblock_device` on CUDA tensors launches the CUDA kernel in
`csrc/deblock.cu` (its header states the design and what bounds it on an
H100) once: both directions, the luma and both chroma planes, read from
the input and written to new planes; `deblock_frames` takes F pictures in
the same one launch. On CPU tensors both run the plain torch version,
`deblock_device_ref`: every 4-line edge segment of the picture is one lane
of a dense (segments, edges) batch, with inactive segments masked to
passthrough. The written windows of neighbouring edges tile the sample
grid exactly (a vertical edge at x rewrites columns x-4..x+3; edges are 8
apart), so a direction pass is reshape -> elementwise filter -> reshape,
with no data-dependent scatter. The horizontal pass reuses the vertical
routine on transposed planes (the filter is symmetric under transposition
with p=above -> p=left).

Bit-exact with the numpy twin and the scalar oracle decode/deblock.py
(reference: turing/LoopFilter.h:425-608).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from turingcodec_tpu_torch.decode.deblock import BETA_TABLE, TC_TABLE
from turingcodec_tpu_torch.hevc.tables import CHROMA_QP_TABLE_420
from turingcodec_tpu_torch.ops import kernel_build
from turingcodec_tpu_torch.ops.dense_me import edge_pad
from turingcodec_tpu_torch.ops.kernel_build import table

# kernel launches since import (or since a caller reset it to 0): one per
# deblock_device or deblock_frames call on the card
launches = 0
_LAUNCH = None
# the types the kernel reads: the plan's own (decode/plan.py) for the 11
# maps (tu_id, pu_id, cu_id, pred_mode, cbf_y, ref_idx, ref_poc, mv, qp_y,
# slice_idx, tile_id) and the 6 per-slice vectors (disabled, across,
# beta, tc, cb and cr offsets)
MAP_DTYPES = (torch.int32, torch.int32, torch.int32, torch.uint8,
              torch.uint8, torch.int8, torch.int32, torch.int16, torch.int8,
              torch.int32, torch.int32)
SLICE_DTYPES = (torch.bool, torch.bool) + (torch.int32,) * 4


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
    if across_tiles is not True:   # False, or a frame's flag under vmap
        edge &= across_tiles | (tile_id[cyq, cxp] == tile_id[cyq, cxq])

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


def deblock_device_ref(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                       across_tiles):
    """Plain torch version of deblock_device: vertical then horizontal
    edges, the horizontal pass on transposed planes and maps; returns new
    contiguous (ry, rcb, rcr). across_tiles: a bool, or a bool tensor (a
    frame's flag under torch.func.vmap).

    mv swap note: mv is (2, h4, w4, 2) with components (x, y); under
    transposition the filter only uses |dx|>=4 | |dy|>=4, which is
    symmetric, so components are NOT swapped."""
    ry, rcb, rcr = _dir_pass(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                             across_tiles, chroma=True)
    ry_t, rcb_t, rcr_t = _dir_pass(
        ry.T, rcb.T, rcr.T, _transpose_maps(maps), sl, ctb_log2, bd_y,
        bd_c, across_tiles, chroma=True)
    return ry_t.T.contiguous(), rcb_t.T.contiguous(), rcr_t.T.contiguous()


def deblock_device(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                   across_tiles):
    """Full deblock (vertical then horizontal) of one picture: ry (H, W),
    rcb/rcr (H/2, W/2) int16, the 11 plan maps and 6 per-slice vectors of
    plan_tensors; returns new contiguous (ry, rcb, rcr). across_tiles: a
    bool, or a bool tensor (a frame's flag under torch.func.vmap). CPU
    tensors take deblock_device_ref; CUDA tensors launch the kernel once,
    and a failed build or launch raises."""
    if ry.device.type == "cpu":
        return deblock_device_ref(ry, rcb, rcr, maps, sl, ctb_log2, bd_y,
                                  bd_c, across_tiles)
    if isinstance(across_tiles, torch.Tensor):
        across_tiles = across_tiles.reshape(1)
    out = deblock_frames(ry[None], rcb[None], rcr[None],
                         tuple(m[None] for m in maps),
                         tuple(v[None] for v in sl), ctb_log2, bd_y, bd_c,
                         across_tiles)
    return tuple(p[0] for p in out)


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("deblock").deblock_launch
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 6 + [i] * 3 + [p] * 11 + [i] * 2 + [p] * 6
                       + [i] + [p] + [i] * 4 + [p])
        _LAUNCH = fn
    return _LAUNCH


def deblock_frames(ry, rcb, rcr, maps, sl, ctb_log2, bd_y, bd_c,
                   across_tiles):
    """deblock_device over F pictures of one size: ry (F, H, W), rcb/rcr
    (F, H/2, W/2) int16 with H and W multiples of 8, each map and
    per-slice vector with a leading F; across_tiles a bool or an (F,) bool
    tensor. Returns the filtered (ry, rcb, rcr) as new tensors, bit-exact
    with per-picture calls. CPU tensors take deblock_device_ref under
    torch.func.vmap; CUDA tensors launch the kernel once (both directions,
    every picture and plane, read from the inputs and written to new
    tensors: the inputs stay as they were), and a failed build or launch
    raises; bit depths 8..16; contiguous CUDA planes must start on 8-byte
    (luma) and 4-byte (chroma) boundaries, as allocations and whole
    pictures of a batch do."""
    global launches
    dev = ry.device
    if dev.type == "cpu":
        def one(y, cb, cr, m, s, a):
            return deblock_device_ref(y, cb, cr, m, s, ctb_log2, bd_y, bd_c,
                                      a)
        if not isinstance(across_tiles, torch.Tensor):
            across_tiles = torch.full((ry.shape[0],), bool(across_tiles))
        return torch.func.vmap(one)(ry, rcb, rcr, tuple(maps), tuple(sl),
                                    across_tiles)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f, h, w = ry.shape
    if (ry.dtype, rcb.dtype, rcr.dtype) != (torch.int16,) * 3:
        raise TypeError("int16 planes required")
    if (h % 8 or w % 8 or tuple(rcb.shape) != (f, h // 2, w // 2)
            or rcr.shape != rcb.shape):
        raise ValueError(f"planes {tuple(ry.shape)}, {tuple(rcb.shape)}, "
                         f"{tuple(rcr.shape)}: (F, H, W) with H and W "
                         f"multiples of 8 and 4:2:0 chroma required")
    if not (8 <= bd_y <= 16 and 8 <= bd_c <= 16):
        raise ValueError(f"bit depths {bd_y}, {bd_c} outside 8..16")
    if ([m.dtype for m in maps] != list(MAP_DTYPES)
            or [v.dtype for v in sl] != list(SLICE_DTYPES)):
        raise TypeError("maps or per-slice vectors not of the plan's types "
                        "(MAP_DTYPES, SLICE_DTYPES)")
    maps = [m.contiguous() for m in maps]
    sl = [v.contiguous() for v in sl]
    h4, w4 = h // 4, w // 4
    hc, wc = maps[9].shape[1:]
    n_sl = sl[0].shape[1]
    want = [(f, h4, w4)] * 5 + [(f, 2, h4, w4)] * 2 + [(f, 2, h4, w4, 2),
                                                       (f, h4, w4)]
    want += [(f, hc, wc)] * 2
    if ([tuple(m.shape) for m in maps] != want
            or any(tuple(v.shape) != (f, n_sl) for v in sl) or n_sl < 1
            or any(t.device != dev for t in (*maps, *sl, rcb, rcr))):
        raise ValueError("maps or per-slice vectors do not fit the planes")
    across_ptr, across_all = None, 1
    if isinstance(across_tiles, torch.Tensor):
        across_tiles = across_tiles.to(dev, torch.bool).contiguous()
        if tuple(across_tiles.shape) != (f,):
            raise ValueError("across_tiles must be a bool or (F,) tensor")
        across_ptr = across_tiles.data_ptr()
    else:
        across_all = int(bool(across_tiles))
    planes = [p.contiguous() for p in (ry, rcb, rcr)]
    if any(p.data_ptr() % a for p, a in zip(planes, (8, 4, 4))):
        raise ValueError("planes must start on 8-byte (luma) and 4-byte "
                         "(chroma) boundaries")
    out = [torch.empty_like(p) for p in planes]
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(*(p.data_ptr() for p in planes),
                *(p.data_ptr() for p in out), f, h, w,
                *(m.data_ptr() for m in maps), hc, wc,
                *(v.data_ptr() for v in sl), n_sl, across_ptr, across_all,
                ctb_log2, bd_y, bd_c, stream)
    if rc != 0:
        raise RuntimeError(f"deblock launch failed: CUDA error {rc}")
    launches += 1
    return tuple(out)


def plan_tensors(plan, geom, device, span=None):
    """The plan's per-block maps and per-slice parameters on `device` (one
    packed upload, from pinned memory on a card), and whether filtering
    crosses tile boundaries: deblock_device's (maps, sl, across_tiles)
    arguments."""
    pps = plan.pps
    shs = plan.slice_headers
    maps = (plan.tu_id, plan.pu_id, plan.cu_id, plan.cu_pred_mode,
            plan.cbf_y, plan.ref_idx, plan.ref_poc, plan.mv, plan.qp_y,
            plan.slice_idx, geom.tile_id)
    sl = (np.asarray([bool(sh.slice_deblocking_filter_disabled_flag)
                      for sh in shs]),
          np.asarray([bool(sh.slice_loop_filter_across_slices_enabled_flag)
                      for sh in shs]),
          np.asarray([sh.slice_beta_offset_div2 << 1 for sh in shs],
                     np.int32),
          np.asarray([sh.slice_tc_offset_div2 << 1 for sh in shs],
                     np.int32),
          np.asarray([pps.pps_cb_qp_offset + sh.slice_cb_qp_offset
                      for sh in shs], np.int32),
          np.asarray([pps.pps_cr_qp_offset + sh.slice_cr_qp_offset
                      for sh in shs], np.int32))
    up = kernel_build.upload_packed(maps + sl, device, span)
    across_tiles = (bool(pps.loop_filter_across_tiles_enabled_flag)
                    or geom.num_tiles == 1)
    return tuple(up[:11]), tuple(up[11:]), across_tiles


def deblock_planes_device(plan, geom, planes, span=None):
    """deblock_device over a plan for [y, cb, cr] device tensors (the
    chained pipeline's deblock); returns the new planes as a list. `span`
    names the maps' upload in the port's trace (upload_packed)."""
    sps = plan.sps
    maps, sl, across_tiles = plan_tensors(plan, geom, planes[0].device,
                                          span)
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
