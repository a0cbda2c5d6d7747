"""Inter reconstruction on a torch device: whole-picture motion compensation
at min-block granularity plus size-bucketed batched residuals, consuming
the plan's numpy tensors (port of `turingcodec_tpu/decode/device_recon.py`).

The host CABAC parse fills the PicturePlan; the device reconstructs every
inter CU in a handful of uniform batched calls: MC as one luma and one
Cb/Cr block grid over the lists that some block uses
(ops/inter.mc_block_grid),
residuals as per-(component, size, mode) (B, n, n) dequant + inverse
transform batches (ops/transform.dequant_inverse_transform). Intra CUs,
deblock and SAO follow on the host. This staged form pulls each result
back to the host planes; decode/device_pipeline.py chains the same stages
on the device.

Bit-exact with decode/recon_vec.py; the decoder selects it with a device
and TURING_TPU_DEVICE_RECON=1. Batches take their exact size: eager torch
has no compile cache to bucket for.
"""
from __future__ import annotations

import numpy as np
import torch

from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
from turingcodec_tpu_torch.ops.inter import mc_block_grid
from turingcodec_tpu_torch.ops.transform import dequant_inverse_transform


def _combine_uni_bi(p0, p1, on0, on1, bd):
    """Default weighted sample prediction from 14-bit parts (8.5.3.3.4).
    A list no block uses comes as None: every block then predicts from the
    other list alone."""
    shift = 14 - bd
    if p0 is None or p1 is None:
        p = p1 if p0 is None else p0
        return ((p + (1 << (shift - 1))) >> shift).clamp(0, (1 << bd) - 1)
    bi = (p0 + p1 + (1 << shift)) >> (shift + 1)
    uni0 = (p0 + (1 << (shift - 1))) >> shift
    uni1 = (p1 + (1 << (shift - 1))) >> shift
    on0 = on0[:, None, None]
    on1 = on1[:, None, None]
    v = torch.where(on0 & on1, bi, torch.where(on0, uni0, uni1))
    return v.clamp(0, (1 << bd) - 1)


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
    bypass (raw residual)."""
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


def _block_index(xs, ys, n):
    """(rows, cols) index arrays of B n x n blocks at (xs, ys); works for
    numpy arrays and torch tensors alike."""
    if isinstance(xs, torch.Tensor):
        ar = torch.arange(n, device=xs.device)
        xs, ys = xs.long(), ys.long()
    else:
        ar = np.arange(n)
    return (ys[:, None, None] + ar[None, :, None],
            xs[:, None, None] + ar[None, None, :])


def _residuals(levels, qp, bd, log2, mode):
    """(B, n, n) int32 residuals of one bucket (see _residual_groups)."""
    if mode == 2:  # transquant bypass: residual = parsed coefficients
        return levels
    return dequant_inverse_transform(levels, qp, bd, log2, mode)


def _inter_residuals_device(plan, recon, device):
    sps = plan.sps
    planes = {0: (plan.coeff_y, recon[0], sps.bit_depth_y),
              1: (plan.coeff_cb, recon[1], sps.bit_depth_c),
              2: (plan.coeff_cr, recon[2], sps.bit_depth_c)}
    for (comp, log2, mode), items in _residual_groups(plan).items():
        coeffp, rplane, bd = planes[comp]
        n = 1 << log2
        xs, ys, qpa = np.asarray(items, np.int32).T.copy()
        rows, cols = _block_index(xs, ys, n)
        levels = torch.from_numpy(coeffp[rows, cols].astype(np.int32))
        res = _residuals(levels.to(device), torch.from_numpy(qpa).to(device),
                         bd, log2, mode).cpu().numpy()
        blk = rplane[rows, cols].astype(np.int32) + res
        rplane[rows, cols] = np.clip(blk, 0, (1 << bd) - 1)
