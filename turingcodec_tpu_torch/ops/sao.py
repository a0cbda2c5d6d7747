"""SAO filter as torch code on a device: the twin of decode/sao.py (port of
`turingcodec_tpu/ops/sao.py`).

The whole plane is filtered in one dense pass: per-CTB parameter maps
(type/class/offsets) are upsampled to sample resolution, the four
edge-offset classes are computed with whole-plane rolls and selected per
sample, and every mask (picture border, slice/tile neighbour rules,
PCM/transquant-bypass skips, per-slice enables) is elementwise.

Bit-exact with decode/sao.py; reference: turing/sao.h:29-34, sao.cpp.
"""
from __future__ import annotations

import numpy as np
import torch

# eoClass -> neighbour a offset (dy, dx); b is always the negation
_EO_A = ((0, -1), (-1, 0), (-1, -1), (-1, 1))
_REMAP = (1, 2, 0, 3, 4)


def _up(m, fy, fx, h, w):
    """Upsample a per-CTB (or per-4x4) map to sample resolution and crop."""
    return m.repeat_interleave(fy, 0).repeat_interleave(fx, 1)[:h, :w]


def _sao_plane(src, ctb, bd, sub, sao_type, sao_class, sao_off,
               slice_up, tile_up, enable_s, across_s, across_tiles,
               skip_up):
    """One plane. src (h, w); sao_* are per-CTB maps; *_up are
    sample-resolution maps; enable_s/across_s index per slice;
    across_tiles is a bool."""
    h, w = src.shape
    dev = src.device
    max_val = (1 << bd) - 1
    p = src.to(torch.int32)
    where = torch.where

    t_up = _up(sao_type, ctb, ctb, h, w)
    cls_up = _up(sao_class, ctb, ctb, h, w)
    offs_up = [_up(sao_off[:, :, k], ctb, ctb, h, w) for k in range(4)]

    # ---- band offset ---------------------------------------------------
    idx = ((p >> (bd - 5)) - cls_up) & 31
    band_res = p
    for k in range(4):
        band_res = where(idx == k, p + offs_up[k], band_res)
    band_res = band_res.clamp(0, max_val)

    # ---- edge offset: all four classes, then per-sample select ---------
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    cur_slice = slice_up
    cur_tile = tile_up
    remap = torch.as_tensor(_REMAP, dtype=torch.int32, device=dev)
    allowed = where(cur_slice >= 0,
                    across_s[cur_slice.clamp(min=0).long()], True)
    edge_res = p
    for eo, (ady, adx) in enumerate(_EO_A):
        a = torch.roll(p, (-ady, -adx), (0, 1))
        b = torch.roll(p, (ady, adx), (0, 1))
        inb = ((ys + ady >= 0) & (ys + ady < h) & (xs + adx >= 0)
               & (xs + adx < w)
               & (ys - ady >= 0) & (ys - ady < h) & (xs - adx >= 0)
               & (xs - adx < w))
        # slice/tile neighbour usability (both directions)
        nb_sl_a = torch.roll(cur_slice, (-ady, -adx), (0, 1))
        nb_sl_b = torch.roll(cur_slice, (ady, adx), (0, 1))
        ok = ((cur_slice == nb_sl_a) | allowed) \
            & ((cur_slice == nb_sl_b) | allowed)
        if not across_tiles:
            ok &= ((cur_tile == torch.roll(cur_tile, (-ady, -adx), (0, 1)))
                   & (cur_tile == torch.roll(cur_tile, (ady, adx), (0, 1))))
        valid = inb & ok
        eidx = remap[(2 + torch.sign(p - a) + torch.sign(p - b)).long()]
        off = torch.zeros_like(p)
        for k in range(4):
            off = where(eidx == k + 1, offs_up[k], off)
        res = where(valid, (p + off).clamp(0, max_val), p)
        edge_res = where(cls_up == eo, res, edge_res)

    enabled = where(cur_slice >= 0,
                    enable_s[cur_slice.clamp(min=0).long()], False)
    out = where(t_up == 1, band_res, where(t_up == 2, edge_res, p))
    out = where(enabled & (t_up > 0) & ~skip_up, out, p)
    return out.to(src.dtype)


def sao_picture_device(plan, geom, deblocked, device, pull=True):
    """Apply SAO on `device` to [y, cb, cr] (numpy planes or tensors on
    `device`); returns new numpy planes (drop-in for decode/sao.sao_picture)
    or, with pull=False, new tensors left on the device: the chained
    pipeline's mode (decode/device_pipeline.py)."""
    sps, pps = plan.sps, plan.pps
    shs = plan.slice_headers

    def up(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    across_s = up([bool(sh.slice_loop_filter_across_slices_enabled_flag)
                   for sh in shs] or [True])
    across_tiles = (bool(pps.loop_filter_across_tiles_enabled_flag)
                    or geom.num_tiles == 1)

    # 4x4-grid skip mask (PCM w/ loop filter disabled, transquant bypass)
    h4 = sps.pic_height_in_luma_samples // 4
    w4 = sps.pic_width_in_luma_samples // 4
    skip4 = np.zeros((h4, w4), bool)
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        skip4 |= np.asarray(plan.pcm_flag, bool)[:h4, :w4]
    if pps.transquant_bypass_enabled_flag:
        skip4 |= np.asarray(plan.tq_bypass, bool)[:h4, :w4]
    skip4 = up(skip4)
    slice_idx = up(plan.slice_idx, torch.int32)
    tile_id = up(geom.tile_id, torch.int32)

    out = []
    n_planes = 3 if sps.chroma_array_type else 1
    for c_idx in range(len(deblocked)):
        src = deblocked[c_idx]
        if c_idx >= n_planes:
            out.append(src.copy() if isinstance(src, np.ndarray)
                       else src.clone())
            continue
        sub = 1 if c_idx == 0 else 2
        ctb = sps.ctb_size_y // sub
        bd = sps.bit_depth_y if c_idx == 0 else sps.bit_depth_c
        h, w = src.shape
        enable_s = up([bool(sh.slice_sao_luma_flag if c_idx == 0
                            else sh.slice_sao_chroma_flag) for sh in shs]
                      or [False])
        f = 4 // sub
        res = _sao_plane(
            torch.as_tensor(src, device=device), int(ctb), int(bd), int(sub),
            up(plan.sao_type[:, :, c_idx], torch.int32),
            up(plan.sao_class[:, :, c_idx], torch.int32),
            up(plan.sao_offsets[:, :, c_idx], torch.int32),
            _up(slice_idx, ctb, ctb, h, w), _up(tile_id, ctb, ctb, h, w),
            enable_s, across_s, across_tiles, _up(skip4, f, f, h, w))
        out.append(res.cpu().numpy() if pull else res)
    return out
