"""Sample adaptive offset filter (spec 8.7.3) — numpy reference.

Parity reference: turing/sao.h:29-34, sao.cpp. Classification reads the
deblocked picture; output goes to a fresh buffer (SAO is not applied in-place
sample-by-sample).
"""
from __future__ import annotations

import numpy as np

from turingcodec_tpu_torch.decode.plan import PicturePlan

# eoClass -> (neighbour a offset, neighbour b offset) in (dy, dx)
_EO_NEIGHBOURS = {
    0: ((0, -1), (0, 1)),    # horizontal
    1: ((-1, 0), (1, 0)),    # vertical
    2: ((-1, -1), (1, 1)),   # 135 degree
    3: ((-1, 1), (1, -1)),   # 45 degree
}


def sao_picture(plan: PicturePlan, geom, deblocked):
    """Apply SAO to [y, cb, cr] deblocked planes; returns new planes."""
    from turingcodec_tpu_torch import native
    res = native.sao_apply(plan, geom, deblocked)
    if res is not None:
        return res
    sps, pps = plan.sps, plan.pps
    out = [p.copy() for p in deblocked]
    ctb = sps.ctb_size_y
    hc, wc = sps.pic_height_in_ctbs_y, sps.pic_width_in_ctbs_y
    # no-filter mask sources
    for cy in range(hc):
        for cx in range(wc):
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
                _sao_ctb(plan, geom, deblocked[c_idx], out[c_idx],
                         cx, cy, c_idx, t)
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

    # skip mask: PCM w/ loop filter disabled, transquant bypass
    skip = None
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        skip = plan.pcm_flag
    if pps.transquant_bypass_enabled_flag:
        skip = plan.tq_bypass if skip is None else (plan.tq_bypass | plan.pcm_flag)

    if sao_type == 1:  # band
        shift = bd - 5
        band_pos = int(plan.sao_class[cy, cx, c_idx])
        band_of = block >> shift
        res = block.copy()
        for k in range(4):
            b = (band_pos + k) & 31
            res = np.where(band_of == b, block + offsets[k], res)
        res = np.clip(res, 0, max_val)
    else:  # edge
        eo = int(plan.sao_class[cy, cx, c_idx])
        (ady, adx), (bdy, bdx) = _EO_NEIGHBOURS[eo]
        bh, bw = block.shape
        ys, xs = np.mgrid[y0:y1, x0:x1]
        ay, ax = ys + ady, xs + adx
        by_, bx_ = ys + bdy, xs + bdx
        valid = (ay >= 0) & (ay < h) & (ax >= 0) & (ax < w) & \
                (by_ >= 0) & (by_ < h) & (bx_ >= 0) & (bx_ < w)
        # slice/tile boundary constraint: neighbour must be filterable
        valid &= _neighbour_ok(plan, geom, ys * sub, xs * sub,
                               ay * sub, ax * sub)
        valid &= _neighbour_ok(plan, geom, ys * sub, xs * sub,
                               by_ * sub, bx_ * sub)
        a_vals = src[np.clip(ay, 0, h - 1), np.clip(ax, 0, w - 1)].astype(np.int32)
        b_vals = src[np.clip(by_, 0, h - 1), np.clip(bx_, 0, w - 1)].astype(np.int32)
        sign_a = np.sign(block - a_vals)
        sign_b = np.sign(block - b_vals)
        edge_idx = 2 + sign_a + sign_b
        # remap: {0->1, 1->2, 2->0, 3->3, 4->4}
        remap = np.array([1, 2, 0, 3, 4], dtype=np.int32)
        edge_idx = remap[edge_idx]
        off_lut = np.array([0, offsets[0], offsets[1], offsets[2], offsets[3]],
                           dtype=np.int32)
        res = np.where(valid, np.clip(block + off_lut[edge_idx], 0, max_val),
                       block)
    if skip is not None:
        sk = skip[(y0 * sub) >> 2:(y1 * sub) >> 2:1, (x0 * sub) >> 2:(x1 * sub) >> 2:1]
        sk_full = np.kron(sk, np.ones((4 // sub, 4 // sub), dtype=bool))
        sk_full = sk_full[:res.shape[0], :res.shape[1]]
        res = np.where(sk_full, block, res)
    dst[y0:y1, x0:x1] = res


def _neighbour_ok(plan, geom, y_l, x_l, yn_l, xn_l):
    """SAO edge neighbour usability across slice/tile boundaries (8.7.3)."""
    sps = plan.sps
    h = sps.pic_height_in_luma_samples
    w = sps.pic_width_in_luma_samples
    yn = np.clip(yn_l, 0, h - 1)
    xn = np.clip(xn_l, 0, w - 1)
    cl2 = sps.ctb_log2_size_y
    cur_slice = plan.slice_idx[y_l >> cl2, x_l >> cl2]
    nb_slice = plan.slice_idx[yn >> cl2, xn >> cl2]
    cur_tile = geom.tile_id[y_l >> cl2, x_l >> cl2]
    nb_tile = geom.tile_id[yn >> cl2, xn >> cl2]
    ok = np.ones(cur_slice.shape, dtype=bool)
    if not plan.pps.loop_filter_across_tiles_enabled_flag:
        ok &= cur_tile == nb_tile
    # slice boundaries: use current slice's flag (conservative approximation
    # of 8.7.3's two-sided rule; exact for single-slice pictures)
    flags = np.array([sh.slice_loop_filter_across_slices_enabled_flag
                      for sh in plan.slice_headers], dtype=bool)
    same = cur_slice == nb_slice
    allowed = np.where(cur_slice >= 0, flags[np.clip(cur_slice, 0, len(flags) - 1)], True)
    ok &= same | allowed
    return ok
