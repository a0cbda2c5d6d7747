"""Inter reconstruction on a torch device: whole-picture motion compensation
at min-block granularity plus the picture's residuals in one call,
consuming the plan's numpy tensors (port of
`turingcodec_tpu/decode/device_recon.py`).

The host CABAC parse fills the PicturePlan; the device reconstructs every
inter CU in a handful of uniform batched calls: MC as one luma and one
Cb/Cr block grid over the lists that some block uses
(ops/inter.mc_block_grid), and the residuals of every coded inter TU of
all three components as one dequant + inverse transform + add call
(ops/transform.dequant_idct_add) over a TU table that `_residual_table`
builds with numpy from the parser's records. Intra CUs, deblock and SAO
follow on the host. This staged form pulls each result back to the host
planes; decode/device_pipeline.py chains the same stages on the device.

Bit-exact with decode/recon_vec.py; the decoder selects it with a device
and TURING_TPU_DEVICE_RECON=1. Batches take their exact size: eager torch
has no compile cache to bucket for.
"""
from __future__ import annotations

import numpy as np
import torch

from turingcodec_tpu_torch import native
from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
from turingcodec_tpu_torch.ops.inter import _combine_uni_bi, mc_block_grid
from turingcodec_tpu_torch.ops.transform import dequant_idct_add, tu_kind


def _mc_plane(planes, ref_sel, mvx, mvy, bx4, by4, on, bs, taps, shift_mv,
              bd):
    """14-bit predictions of every block, (L, C, B, bs, bs) for the L lists
    and C components of `planes` (see ops/inter.mc_block_grid), from (L, B)
    motion."""
    xi = bx4 * bs + (mvx >> shift_mv)
    yi = by4 * bs + (mvy >> shift_mv)
    frac_mask = (1 << shift_mv) - 1
    sel = torch.where(on, ref_sel, 0)
    return mc_block_grid(planes, sel, xi, yi, mvx & frac_mask,
                         mvy & frac_mask, bs, taps, bd)


def _inter_blocks(plan):
    """(by4, bx4) of every inter min-block with motion, or None."""
    inter = (plan.cu_pred_mode == 0) & (plan.cu_id >= 0) & (
        (plan.ref_idx[0] >= 0) | (plan.ref_idx[1] >= 0))
    if not inter.any():
        return None
    return np.nonzero(inter)


def _predict(plan, by4, bx4, refs, device):
    """MC and the uni/bi combine of every inter min-block: (pred_y,
    pred_cb, pred_cr) as (B, 4, 4) and 2 x (B, 2, 2) int32 on `device`.
    refs[lx] lists list lx's reference pictures as (y, cb, cr) int16
    planes on `device`. The lists some block uses (list 1 of a P picture
    is empty), decided from the host's plan, go to MC together: one launch
    for luma and one for Cb and Cr. Their per-block motion goes up in one
    transfer."""
    sps = plan.sps
    bd_y, bd_c = sps.bit_depth_y, sps.bit_depth_c
    used = [lx for lx in (0, 1) if (plan.ref_idx[lx, by4, bx4] >= 0).any()]
    rows = [bx4, by4]
    for lx in used:
        rows += [plan.ref_idx[lx, by4, bx4], plan.mv[lx, by4, bx4, 0],
                 plan.mv[lx, by4, bx4, 1]]
    motion = torch.from_numpy(np.stack(rows).astype(np.int32)).to(device)
    jb_x, jb_y = motion[0], motion[1]
    r, mvx, mvy = motion[2:].reshape(len(used), 3, -1).unbind(1)  # (L, B)
    on = r >= 0
    sel = r.clamp(min=0)
    p14_y = _mc_plane([[[d[0] for d in refs[lx]]] for lx in used], sel, mvx,
                      mvy, jb_x, jb_y, on, 4, 8, 2, bd_y)[:, 0]
    p14_c = _mc_plane([[[d[c] for d in refs[lx]] for c in (1, 2)]
                       for lx in used], sel, mvx, mvy, jb_x, jb_y, on, 2, 4,
                      3, bd_c)

    def combine(p, bd):  # p: (L, B, bs, bs), one row per used list
        parts, flags = dict(zip(used, p)), dict(zip(used, on))
        return _combine_uni_bi(parts.get(0), parts.get(1), flags.get(0),
                               flags.get(1), bd)

    return (combine(p14_y, bd_y), combine(p14_c[:, 0], bd_c),
            combine(p14_c[:, 1], bd_c))


def reconstruct_inter_device(plan, geom, ref_lists, recon, device):
    """Device twin of recon_vec.reconstruct_inter_batch: MC + residual add
    for all inter CUs on `device`, writing into the [y, cb, cr] int16 host
    planes."""
    blocks = _inter_blocks(plan)
    if blocks is None:
        return
    by4, bx4 = blocks
    h4, w4 = geom.h4, geom.w4
    refs, uploaded = [], {}
    for lx in (0, 1):
        lst = ref_lists[lx] if lx < len(ref_lists) else []
        for p in lst:   # a picture in both lists goes up once
            if id(p.planes[0]) not in uploaded:
                uploaded[id(p.planes[0])] = tuple(torch.from_numpy(
                    np.ascontiguousarray(p.planes[c])).to(device)
                    for c in range(3))
        refs.append([uploaded[id(p.planes[0])] for p in lst])
    preds = _predict(plan, by4, bx4, refs, device)
    # scatter the (B, bs, bs) blocks into the planes (blocks are disjoint)
    for plane, pred, bs in zip(recon, preds, (4, 2, 2)):
        plane.reshape(h4, bs, w4, bs).transpose(0, 2, 1, 3)[by4, bx4] = \
            pred.cpu().numpy()
    _inter_residuals_device(plan, recon, device)


def _residual_groups(plan):
    """Inter TUs with coded residuals, bucketed: {(component, log2 size,
    mode): [(x, y, qp), ...]} in component samples; mode 0 = dequant +
    inverse DCT, 1 = transform skip (dequant + shift), 2 = transquant
    bypass (raw residual). The plain walk of `plan.cu_list` (JAX
    `device_pipeline._residuals_device`, line for line) that the tests
    hold `_residual_table` against; nothing on the decode path calls it."""
    sps = plan.sps
    groups = {}
    for cu in plan.cu_list:
        if cu.pred_mode != 0 or cu.pcm or cu.skip or not cu.tus:
            continue
        cu_mode = 2 if cu.tq_bypass else 0
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
            if cbf_y:
                mode = cu_mode
                if not mode and plan.transform_skip_y[y0 >> 2, x0 >> 2]:
                    mode = 1
                groups.setdefault((0, log2, mode), []).append(
                    (x0, y0, qp_y))
            if log2 > 2:
                cx, cy, cl = x0 >> 1, y0 >> 1, log2 - 1
            elif blk_idx == 3:
                cx, cy, cl = xb >> 1, yb >> 1, 2
            else:
                continue
            if cbf_cb:
                mode = cu_mode
                if not mode and plan.transform_skip_cb[cy >> 1, cx >> 1]:
                    mode = 1
                groups.setdefault((1, cl, mode), []).append(
                    (cx, cy, qp_cb))
            if cbf_cr:
                mode = cu_mode
                if not mode and plan.transform_skip_cr[cy >> 1, cx >> 1]:
                    mode = 1
                groups.setdefault((2, cl, mode), []).append(
                    (cx, cy, qp_cr))
    return groups


def _residual_table(plan):
    """The TU table of ops/transform.dequant_idct_add for every coded inter
    TU of the picture: (T, 4) int32 rows (x, y, qp, kind) in component
    samples, with the QP offset for the bit depth; the same TUs as
    `_residual_groups`, built with numpy from the parser's records
    (`native._recon_records`, which builds them from `cu_list` when the
    Python parser made it)."""
    cu, tu = native._recon_records(plan, 0)
    if cu is None:
        return np.zeros((0, 4), np.int32)
    sps = plan.sps
    # records: cu (x0, y0, log2, part, skip, tqb, ntus, 0), tu (x0, y0,
    # log2, blk_idx, x_base, y_base, cbf_y, cbf_cb, cbf_cr)
    ntus = cu[:, 6].astype(np.int64)
    owner = np.repeat(np.arange(len(cu)), ntus)
    tu = tu[:len(owner)]
    keep = cu[owner, 4] == 0                     # skipped CUs: no residual
    tu, owner = tu[keep], owner[keep]
    cx0, cy0 = cu[owner, 0], cu[owner, 1]
    tqb = cu[owner, 5] != 0
    qpy = plan.qp_y[cy0 >> 2, cx0 >> 2].astype(np.int32)
    ctb = sps.ctb_log2_size_y
    sl = plan.slice_idx[cy0 >> ctb, cx0 >> ctb]
    off_c = sps.qp_bd_offset_c
    cqt = native._cqt_table(sps)                 # indexed by qPi + off_c
    qp_c = [cqt[np.clip(qpy + off[sl], -off_c, 57) + off_c] + off_c
            for off in native._slice_qp_offsets(plan)]

    x0, y0, log2, blk, xb, yb = (tu[:, i] for i in range(6))
    parts = []
    on = tu[:, 6] != 0
    mode = np.where(tqb, 2, plan.transform_skip_y[y0 >> 2, x0 >> 2] != 0)
    parts.append(np.stack([x0, y0, qpy + sps.qp_bd_offset_y,
                           tu_kind(0, log2, mode)], 1)[on])
    # chroma: a TU above 4x4 carries its own; a split 8x8 carries its
    # chroma at the fourth 4x4 (blk_idx 3), at the 8x8's origin
    big = log2 > 2
    has_c = big | (blk == 3)
    cx = np.where(big, x0, xb) >> 1
    cy = np.where(big, y0, yb) >> 1
    cl = np.where(big, log2 - 1, 2)
    for comp, skip_map in ((1, plan.transform_skip_cb),
                           (2, plan.transform_skip_cr)):
        on = has_c & (tu[:, 6 + comp] != 0)
        mode = np.where(tqb, 2, skip_map[cy >> 1, cx >> 1] != 0)
        parts.append(np.stack([cx, cy, qp_c[comp - 1],
                               tu_kind(comp, cl, mode)], 1)[on])
    return np.concatenate(parts).astype(np.int32)


def _inter_residuals_device(plan, recon, device):
    """The picture's residuals on `device`, added into the [y, cb, cr]
    int16 host planes: one upload of the level and predicted planes, one
    dequant_idct_add call, one pull."""
    table = _residual_table(plan)
    if not len(table):
        return
    sps = plan.sps
    host = [plan.coeff_y, plan.coeff_cb, plan.coeff_cr] + list(recon)
    # one transfer up (the concatenation is a copy: on device="cpu" the
    # tensors never alias the host planes) and one down
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.int16).ravel() for a in host])).to(device)
    views = [v.view(a.shape) for v, a in zip(
        flat.split([a.size for a in host]), host)]
    planes = dequant_idct_add(views[:3], views[3:], table,
                              (sps.bit_depth_y, sps.bit_depth_c,
                               sps.bit_depth_c))
    out = torch.cat([p.reshape(-1) for p in planes]).cpu().numpy()
    for plane, part in zip(recon, np.split(out, np.cumsum(
            [p.size for p in recon])[:-1])):
        plane[...] = part.reshape(plane.shape)
