"""SAO filter on a device: the twin of decode/sao.py (port of
`turingcodec_tpu/ops/sao.py`).

`sao_frames` filters one component of F pictures from their per-CTB maps:
CUDA tensors launch the CUDA kernel in `csrc/sao.cu` (its header states
the design and what bounds it on an H100), one launch for the F pictures;
CPU tensors take the plain torch version `_sao_plane` per picture, which
filters the whole plane in one dense pass: per-CTB parameter maps
(type/class/offsets) are upsampled to sample resolution, the four
edge-offset classes are computed with whole-plane rolls and selected per
sample, and every mask (picture border, slice/tile neighbour rules,
PCM/transquant-bypass skips, per-slice enables) is elementwise.
`sao_picture_device` runs it for each component of a picture.

Bit-exact with decode/sao.py; reference: turing/sao.h:29-34, sao.cpp.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from turingcodec_tpu_torch.ops import kernel_build

# kernel launches since import (or since a caller reset it to 0): one per
# sao_frames call on the card
launches = 0
_LAUNCH = None

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
    across_tiles is a bool, or a bool tensor (a frame's flag under
    torch.func.vmap)."""
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
        if across_tiles is not True:  # False, or a frame's flag under vmap
            ok &= across_tiles | (
                (cur_tile == torch.roll(cur_tile, (-ady, -adx), (0, 1)))
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


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _picture_maps(plan, geom, device):
    """A picture's SAO maps on `device`, in one packed upload (pinned on a
    card): what every component's call shares (the per-slice across
    flags, the tile flag, the slice, tile and 4x4 skip maps) and each
    component's per-CTB type, class and offsets and per-slice enables
    (indexed by component first)."""
    sps, pps = plan.sps, plan.pps
    shs = plan.slice_headers
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
    names = ("across_s", "skip4", "slice_idx", "tile_id", "sao_type",
             "sao_class", "sao_off", "enable")
    i32 = np.int32
    arrays = (
        np.asarray([bool(sh.slice_loop_filter_across_slices_enabled_flag)
                    for sh in shs] or [True]),
        skip4, np.asarray(plan.slice_idx, i32), np.asarray(geom.tile_id, i32),
        np.moveaxis(np.asarray(plan.sao_type, i32), -1, 0),
        np.moveaxis(np.asarray(plan.sao_class, i32), -1, 0),
        np.moveaxis(np.asarray(plan.sao_offsets, i32), 2, 0),
        np.asarray([[bool(sh.slice_sao_luma_flag) for sh in shs] or [False]]
                   + [[bool(sh.slice_sao_chroma_flag) for sh in shs]
                      or [False]] * 2))
    maps = dict(zip(names, kernel_build.upload_packed(arrays, device)))
    maps["across_tiles"] = across_tiles
    return maps


def sao_plane_args(plan, maps, c_idx, src):
    """The arguments of _sao_plane for component c_idx of a picture, src
    its deblocked plane as a tensor on the maps' device (`maps` from
    _picture_maps)."""
    sps = plan.sps
    shs = plan.slice_headers
    dev = src.device
    sub = 1 if c_idx == 0 else 2
    ctb = int(sps.ctb_size_y // sub)
    bd = int(sps.bit_depth_y if c_idx == 0 else sps.bit_depth_c)
    h, w = src.shape
    enable_s = _tensor([bool(sh.slice_sao_luma_flag if c_idx == 0
                             else sh.slice_sao_chroma_flag) for sh in shs]
                       or [False], dev)
    f = 4 // sub
    return (src, ctb, bd, sub,
            _tensor(plan.sao_type[:, :, c_idx], dev, torch.int32),
            _tensor(plan.sao_class[:, :, c_idx], dev, torch.int32),
            _tensor(plan.sao_offsets[:, :, c_idx], dev, torch.int32),
            _up(maps["slice_idx"], ctb, ctb, h, w),
            _up(maps["tile_id"], ctb, ctb, h, w),
            enable_s, maps["across_s"], maps["across_tiles"],
            _up(maps["skip4"], f, f, h, w))


def sao_ctb_args(plan, maps, c_idx, src):
    """sao_frames's arguments for component c_idx of one picture, with a
    frame axis of 1: src its deblocked plane as a tensor on the maps'
    device (`maps` from _picture_maps), every map per CTB (per 4x4 block
    for the skip map)."""
    sps = plan.sps
    sub = 1 if c_idx == 0 else 2
    return (src[None], int(sps.ctb_size_y // sub),
            int(sps.bit_depth_y if c_idx == 0 else sps.bit_depth_c), sub,
            *(maps[k][c_idx:c_idx + 1] for k in ("sao_type", "sao_class",
                                                  "sao_off")),
            maps["slice_idx"][None], maps["tile_id"][None],
            maps["enable"][c_idx:c_idx + 1], maps["across_s"][None],
            maps["across_tiles"], maps["skip4"][None])


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("sao").sao_launch
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, p] + [i] * 3 + [p] * 3 + [i] + [p] * 2 + [i]
                       + [p] * 2 + [i] + [p] + [i] + [p] + [i] * 2 + [p])
        _LAUNCH = fn
    return _LAUNCH


def sao_frames(src, ctb, bd, sub, sao_type, sao_class, sao_off, slice_ctb,
               tile_ctb, enable_s, across_s, across_tiles, skip4):
    """SAO of one component of F pictures of one size: src (F, h, w) int16
    deblocked planes; per CTB of the component (ctb samples a side, a power
    of two) sao_type/sao_class (F, hc, wc), sao_off (F, hc, wc, 4 or
    more), slice_ctb/tile_ctb (F, hc, wc); per slice enable_s/across_s
    (F, S) bool; across_tiles a bool or an (F,) bool tensor; skip4 (F,
    h*sub/4, w*sub/4) bool, the picture's 4x4 luma grid (sub = 1 for luma,
    2 for 4:2:0 chroma). Returns new (F, h, w) planes, each equal to
    _sao_plane's. CPU tensors take _sao_plane under torch.func.vmap on the
    maps upsampled to sample resolution; CUDA tensors launch the kernel
    once, and a failed build or launch raises; bit depths 8..16."""
    global launches
    f, h, w = src.shape
    dev = src.device
    k = 4 // sub
    if dev.type == "cpu":
        def one(s, t, c, o, sl, tl, en, ac, at, sk):
            return _sao_plane(s, ctb, bd, sub, t, c, o,
                              _up(sl, ctb, ctb, h, w), _up(tl, ctb, ctb, h, w),
                              en, ac, at, _up(sk, k, k, h, w))
        if not isinstance(across_tiles, torch.Tensor):
            across_tiles = torch.full((f,), bool(across_tiles))
        return torch.func.vmap(one)(src, sao_type, sao_class, sao_off,
                                    slice_ctb, tile_ctb, enable_s, across_s,
                                    across_tiles, skip4)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if src.dtype != torch.int16:
        raise TypeError(f"int16 planes required, got {src.dtype}")
    if not 8 <= bd <= 16:
        raise ValueError(f"bit depth {bd} outside 8..16")
    if ctb < 1 or ctb & (ctb - 1) or sub not in (1, 2):
        raise ValueError(f"ctb {ctb} (a power of two), sub {sub} (1 or 2)")
    ctb_log2, skip_log2 = ctb.bit_length() - 1, k.bit_length() - 1
    hc, wc = -(-h // ctb), -(-w // ctb)
    ctb_maps = [a.contiguous() for a in (sao_type, sao_class, sao_off,
                                         slice_ctb, tile_ctb)]
    flags = [a.contiguous() for a in (enable_s, across_s, skip4)]
    if (any(a.dtype != torch.int32 for a in ctb_maps)
            or any(a.dtype != torch.bool for a in flags)):
        raise TypeError("int32 per-CTB maps and bool flags required")
    n_sl, n_off = flags[0].shape[-1], ctb_maps[2].shape[-1]
    if (any(tuple(a.shape) != (f, hc, wc) for a in ctb_maps[:2]
            + ctb_maps[3:])
            or tuple(ctb_maps[2].shape) != (f, hc, wc, n_off) or n_off < 4
            or tuple(flags[1].shape) != (f, n_sl) or n_sl < 1
            or tuple(flags[2].shape) != (f, -(-h // k), -(-w // k))
            or any(a.device != dev for a in ctb_maps + flags)):
        raise ValueError("maps do not fit the planes")
    across_ptr, across_all = None, 1
    if isinstance(across_tiles, torch.Tensor):
        across_tiles = across_tiles.to(dev, torch.bool).contiguous()
        if tuple(across_tiles.shape) != (f,):
            raise ValueError("across_tiles must be a bool or (F,) tensor")
        across_ptr = across_tiles.data_ptr()
    else:
        across_all = int(bool(across_tiles))
    src = src.contiguous()
    out = torch.empty_like(src)
    if out.numel() == 0:
        return out
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(src.data_ptr(), out.data_ptr(), f, h, w,
                *(a.data_ptr() for a in ctb_maps[:3]), n_off,
                *(a.data_ptr() for a in ctb_maps[3:]), ctb_log2,
                flags[0].data_ptr(), flags[1].data_ptr(), n_sl, across_ptr,
                across_all, flags[2].data_ptr(), skip_log2, bd, stream)
    if rc != 0:
        raise RuntimeError(f"sao launch failed: CUDA error {rc}")
    launches += 1
    return out


def sao_picture_device(plan, geom, deblocked, device, pull=True):
    """Apply SAO on `device` to [y, cb, cr] (numpy planes or tensors on
    `device`); returns new numpy planes (drop-in for decode/sao.sao_picture)
    or, with pull=False, new tensors left on the device: the chained
    pipeline's mode (decode/device_pipeline.py). One sao_frames call per
    component: one kernel launch each on the card."""
    maps = _picture_maps(plan, geom, device)
    out = []
    n_planes = 3 if plan.sps.chroma_array_type else 1
    for c_idx in range(len(deblocked)):
        src = deblocked[c_idx]
        if c_idx >= n_planes:
            out.append(src.copy() if isinstance(src, np.ndarray)
                       else src.clone())
            continue
        res = sao_frames(*sao_ctb_args(
            plan, maps, c_idx, torch.as_tensor(src, device=device)))[0]
        out.append(res.cpu().numpy() if pull else res)
    return out
