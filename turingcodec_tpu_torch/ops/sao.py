"""SAO filter on a device: the twin of decode/sao.py (port of
`turingcodec_tpu/ops/sao.py`).

`sao_picture_frames` filters every component of F pictures from their
per-CTB maps, `sao_frames` one component: CUDA tensors launch the CUDA
kernel in `csrc/sao.cu` (its header states the design and what bounds it
on an H100) once a call, for the F pictures and all their components; CPU
tensors take the plain torch version `_sao_plane` per picture and
component, which filters the whole plane in one dense pass: per-CTB
parameter maps (type/class/offsets) are upsampled to sample resolution,
the four edge-offset classes are computed with whole-plane rolls and
selected per sample, and every mask (picture border, slice/tile neighbour
rules, PCM/transquant-bypass skips, per-slice enables) is elementwise.
`sao_neighbour_mask` is the plain version of the kernel's per-CTB form of
the slice and tile rules. `sao_picture_device` runs one picture: one
kernel launch on the card.

Bit-exact with decode/sao.py; reference: turing/sao.h:29-34, sao.cpp.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from turingcodec_tpu_torch.ops import kernel_build

# kernel launches since import (or since a caller reset it to 0): one per
# sao_frames or sao_picture_frames call on the card
launches = 0
_LAUNCH = None

# eoClass -> neighbour a offset (dy, dx); b is always the negation
_EO_A = ((0, -1), (-1, 0), (-1, -1), (-1, 1))
_REMAP = (1, 2, 0, 3, 4)


def _up(m, fy, fx, h, w):
    """Upsample a per-CTB (or per-4x4) map to sample resolution and crop."""
    return m.repeat_interleave(fy, 0).repeat_interleave(fx, 1)[:h, :w]


def _edge_valid(slice_up, tile_up, across_s, across_tiles, eo):
    """Where an edge offset of class eo may read both its neighbours:
    both in the picture and, in both directions, in the same slice or the
    sample's slice filters across slices (a negative slice: across), and
    in the same tile or across_tiles (a bool, or a frame's flag under
    torch.func.vmap). slice_up/tile_up are sample-resolution maps."""
    h, w = slice_up.shape
    dev = slice_up.device
    ady, adx = _EO_A[eo]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = ((ys + ady >= 0) & (ys + ady < h) & (xs + adx >= 0)
           & (xs + adx < w)
           & (ys - ady >= 0) & (ys - ady < h) & (xs - adx >= 0)
           & (xs - adx < w))
    allowed = torch.where(slice_up >= 0,
                          across_s[slice_up.clamp(min=0).long()], True)
    # slice/tile neighbour usability (both directions)
    nb_sl_a = torch.roll(slice_up, (-ady, -adx), (0, 1))
    nb_sl_b = torch.roll(slice_up, (ady, adx), (0, 1))
    ok = ((slice_up == nb_sl_a) | allowed) & ((slice_up == nb_sl_b) | allowed)
    if across_tiles is not True:  # False, or a frame's flag under vmap
        ok &= across_tiles | (
            (tile_up == torch.roll(tile_up, (-ady, -adx), (0, 1)))
            & (tile_up == torch.roll(tile_up, (ady, adx), (0, 1))))
    return inb & ok


def sao_neighbour_mask(slice_ctb, tile_ctb, across_s, across_tiles):
    """The slice and tile rules once per CTB, as the kernel applies them:
    (hc, wc, 3, 3) bool, [cy, cx, dy + 1, dx + 1] true where an edge
    offset of a sample in CTB (cy, cx) may read a neighbour in CTB
    (cy + dy, cx + dx): that CTB is in the grid, in the same slice or the
    CTB's slice filters across slices (a negative slice: across; indices
    clamped to the per-slice flags), and in the same tile or across_tiles.
    A sample's edge offset is valid where both neighbours lie in the
    picture and the mask holds both their CTBs: _edge_valid's rule."""
    hc, wc = slice_ctb.shape
    dev = slice_ctb.device
    n_sl = across_s.shape[0]
    allowed = torch.where(slice_ctb >= 0,
                          across_s[slice_ctb.clamp(0, n_sl - 1).long()], True)
    mask = torch.zeros((hc, wc, 3, 3), dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = torch.arange(hc, device=dev) + dy
            xs = torch.arange(wc, device=dev) + dx
            inside = (((ys >= 0) & (ys < hc))[:, None]
                      & ((xs >= 0) & (xs < wc))[None, :])
            yc, xc = ys.clamp(0, hc - 1), xs.clamp(0, wc - 1)
            ok = inside & ((slice_ctb[yc][:, xc] == slice_ctb) | allowed)
            if not across_tiles:
                ok &= tile_ctb[yc][:, xc] == tile_ctb
            mask[:, :, dy + 1, dx + 1] = ok
    return mask


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
    remap = torch.as_tensor(_REMAP, dtype=torch.int32, device=dev)
    edge_res = p
    for eo, (ady, adx) in enumerate(_EO_A):
        a = torch.roll(p, (-ady, -adx), (0, 1))
        b = torch.roll(p, (ady, adx), (0, 1))
        valid = _edge_valid(slice_up, tile_up, across_s, across_tiles, eo)
        eidx = remap[(2 + torch.sign(p - a) + torch.sign(p - b)).long()]
        off = torch.zeros_like(p)
        for k in range(4):
            off = where(eidx == k + 1, offs_up[k], off)
        res = where(valid, (p + off).clamp(0, max_val), p)
        edge_res = where(cls_up == eo, res, edge_res)

    enabled = where(slice_up >= 0,
                    enable_s[slice_up.clamp(min=0).long()], False)
    out = where(t_up == 1, band_res, where(t_up == 2, edge_res, p))
    out = where(enabled & (t_up > 0) & ~skip_up, out, p)
    return out.to(src.dtype)


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _picture_maps(plan, geom, device, span=None):
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
    maps = dict(zip(names, kernel_build.upload_packed(arrays, device,
                                                      span)))
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


def sao_picture_args(plan, maps, planes):
    """sao_picture_frames's arguments for one picture, with a frame axis
    of 1: planes its deblocked planes as tensors on the maps' device
    (`maps` from _picture_maps), [y] for a monochrome picture or
    [y, cb, cr]."""
    sps = plan.sps
    n = len(planes)
    return ([p[None] for p in planes], int(sps.ctb_size_y),
            int(sps.bit_depth_y), int(sps.bit_depth_c),
            *(maps[k][:n][None] for k in ("sao_type", "sao_class",
                                          "sao_off")),
            maps["slice_idx"][None], maps["tile_id"][None],
            maps["enable"][:n][None], maps["across_s"][None],
            maps["across_tiles"], maps["skip4"][None])


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("sao").sao_launch
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i, p, p, p, i] + [p] * 3 + [i] + [p] * 2 + [i] * 2
                       + [p] * 2 + [i] + [p] + [i] + [p] + [i] * 2 + [p])
        _LAUNCH = fn
    return _LAUNCH


def _launch(planes, ctbs, subs, bds, sao_type, sao_class, sao_off,
            slice_ctb, tile_ctb, enable_s, across_s, across_tiles, skip4):
    """One kernel launch for the C planes of F pictures, each (F, h, w)
    int16 on one card: plane c with CTBs of ctbs[c] samples, 4x4 luma
    blocks of 4 // subs[c] samples a side, bit depth bds[c]; the per-CTB
    maps and per-slice enables with a component axis after the frame axis
    ((F, C, hc, wc), (F, C, hc, wc, n_off), (F, C, S)), the rest as
    sao_frames takes them. Returns the C new planes."""
    global launches
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(p.dtype != torch.int16 for p in planes):
        raise TypeError("int16 planes required, got "
                        f"{[p.dtype for p in planes]}")
    if any(not 8 <= bd <= 16 for bd in bds):
        raise ValueError(f"bit depths {bds} outside 8..16")
    if any(ctb < 8 or ctb & (ctb - 1) or sub not in (1, 2)
           for ctb, sub in zip(ctbs, subs)):
        raise ValueError(f"ctb {ctbs} (powers of two, 8 or more on the "
                         f"card), sub {subs} (1 or 2)")
    n_comp = len(planes)
    f, h, w = planes[0].shape
    hc, wc = -(-h // ctbs[0]), -(-w // ctbs[0])
    k = 4 // subs[0]
    hs, ws = -(-h // k), -(-w // k)
    ctb_maps = [a.contiguous() for a in (sao_type, sao_class, sao_off,
                                         slice_ctb, tile_ctb)]
    flags = [a.contiguous() for a in (enable_s, across_s, skip4)]
    if (any(a.dtype != torch.int32 for a in ctb_maps)
            or any(a.dtype != torch.bool for a in flags)):
        raise TypeError("int32 per-CTB maps and bool flags required")
    n_sl, n_off = flags[1].shape[-1], ctb_maps[2].shape[-1]
    if (any(tuple(a.shape) != (f, n_comp, hc, wc) for a in ctb_maps[:2])
            or tuple(ctb_maps[2].shape) != (f, n_comp, hc, wc, n_off)
            or n_off < 4
            or any(tuple(a.shape) != (f, hc, wc) for a in ctb_maps[3:])
            or tuple(flags[0].shape) != (f, n_comp, n_sl)
            or tuple(flags[1].shape) != (f, n_sl) or n_sl < 1
            or tuple(flags[2].shape) != (f, hs, ws)
            or any(p.shape[0] != f or -(-p.shape[1] // c) != hc
                   or -(-p.shape[2] // c) != wc
                   or -(-p.shape[1] // (4 // s)) != hs
                   or -(-p.shape[2] // (4 // s)) != ws
                   for p, c, s in zip(planes, ctbs, subs))
            or any(a.device != dev for a in planes + ctb_maps + flags)):
        raise ValueError("maps do not fit the planes")
    across_ptr, across_all = None, 1
    if isinstance(across_tiles, torch.Tensor):
        across_tiles = across_tiles.to(dev, torch.bool).contiguous()
        if tuple(across_tiles.shape) != (f,):
            raise ValueError("across_tiles must be a bool or (F,) tensor")
        across_ptr = across_tiles.data_ptr()
    else:
        across_all = int(bool(across_tiles))
    planes = [p.contiguous() for p in planes]
    outs = [torch.empty_like(p) for p in planes]
    if any(o.numel() == 0 for o in outs):
        return outs
    src = (ctypes.c_void_p * n_comp)(*(p.data_ptr() for p in planes))
    dst = (ctypes.c_void_p * n_comp)(*(o.data_ptr() for o in outs))
    dims = (ctypes.c_int * (5 * n_comp))(*(
        v for p, c, s, bd in zip(planes, ctbs, subs, bds)
        for v in (p.shape[1], p.shape[2], c.bit_length() - 1,
                  (4 // s).bit_length() - 1, bd)))
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(n_comp, ctypes.cast(src, ctypes.c_void_p),
                ctypes.cast(dst, ctypes.c_void_p),
                ctypes.cast(dims, ctypes.c_void_p), f,
                *(a.data_ptr() for a in ctb_maps[:3]), n_off,
                *(a.data_ptr() for a in ctb_maps[3:]), hc, wc,
                flags[0].data_ptr(), flags[1].data_ptr(), n_sl, across_ptr,
                across_all, flags[2].data_ptr(), hs, ws, stream)
    if rc != 0:
        raise RuntimeError(f"sao launch failed: CUDA error {rc}")
    launches += 1
    return outs


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
    once (CTBs of 8 samples or more), and a failed build or launch raises;
    bit depths 8..16."""
    f, h, w = src.shape
    if src.device.type == "cpu":
        k = 4 // sub

        def one(s, t, c, o, sl, tl, en, ac, at, sk):
            return _sao_plane(s, ctb, bd, sub, t, c, o,
                              _up(sl, ctb, ctb, h, w), _up(tl, ctb, ctb, h, w),
                              en, ac, at, _up(sk, k, k, h, w))
        if not isinstance(across_tiles, torch.Tensor):
            across_tiles = torch.full((f,), bool(across_tiles))
        return torch.func.vmap(one)(src, sao_type, sao_class, sao_off,
                                    slice_ctb, tile_ctb, enable_s, across_s,
                                    across_tiles, skip4)
    return _launch([src], [ctb], [sub], [bd], sao_type[:, None],
                   sao_class[:, None], sao_off[:, None], slice_ctb, tile_ctb,
                   enable_s[:, None], across_s, across_tiles, skip4)[0]


def sao_picture_frames(planes, ctb, bd_y, bd_c, sao_type, sao_class, sao_off,
                       slice_ctb, tile_ctb, enable_s, across_s, across_tiles,
                       skip4):
    """SAO of every component of F 4:2:0 or monochrome pictures of one
    size: planes [y] or [y, cb, cr], (F, h, w) int16 deblocked planes (the
    chroma half the luma's sides); ctb the luma CTB side (chroma CTBs half
    of it); bd_y the luma and bd_c the chroma bit depth; per CTB
    sao_type/sao_class (F, C, hc, wc) and sao_off (F, C, hc, wc, 4 or
    more) for the C planes, slice_ctb/tile_ctb (F, hc, wc); per slice
    enable_s (F, C, S) and across_s (F, S) bool; across_tiles a bool or an
    (F,) bool tensor; skip4 (F, h/4, w/4) bool. Returns the C new planes,
    each equal to _sao_plane's. CPU tensors take sao_frames's plain
    version per component; CUDA tensors launch the kernel once for every
    component, and a failed build or launch raises."""
    n = len(planes)
    if n not in (1, 3):
        raise ValueError(f"{n} planes: 1 (monochrome) or 3 (4:2:0)")
    ctbs, subs, bds = ([ctb, ctb // 2, ctb // 2][:n], [1, 2, 2][:n],
                       [bd_y, bd_c, bd_c][:n])
    if planes[0].device.type == "cpu":
        return [sao_frames(planes[c], ctbs[c], bds[c], subs[c],
                           sao_type[:, c], sao_class[:, c], sao_off[:, c],
                           slice_ctb, tile_ctb, enable_s[:, c], across_s,
                           across_tiles, skip4) for c in range(n)]
    return _launch(planes, ctbs, subs, bds, sao_type, sao_class, sao_off,
                   slice_ctb, tile_ctb, enable_s, across_s, across_tiles,
                   skip4)


def sao_picture_device(plan, geom, deblocked, device, pull=True,
                       span=None):
    """Apply SAO on `device` to [y, cb, cr] (numpy planes or tensors on
    `device`); returns new numpy planes (drop-in for decode/sao.sao_picture)
    or, with pull=False, new tensors left on the device: the chained
    pipeline's mode (decode/device_pipeline.py). One sao_picture_frames
    call for the picture's components (luma alone when monochrome): one
    kernel launch on the card. `span` names the maps' upload in the
    port's trace (upload_packed)."""
    maps = _picture_maps(plan, geom, device, span)
    n = 3 if plan.sps.chroma_array_type else 1
    res = sao_picture_frames(*sao_picture_args(
        plan, maps, [torch.as_tensor(deblocked[c], device=device)
                     for c in range(n)]))
    out = [r[0].cpu().numpy() if pull else r[0] for r in res]
    for src in deblocked[n:]:
        out.append(src.copy() if isinstance(src, np.ndarray)
                   else src.clone())
    return out
