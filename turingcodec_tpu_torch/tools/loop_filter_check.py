"""CLI: the decoder's loop-filter kernels against their plain versions.

Synthetic inputs made from a seed (also used by the CPU parity tests
against the JAX package and by chip_smoke.py):
- `deblock_synthetic`: one picture's planes, its 11 deblocking maps and 6
  per-slice vectors (ops/deblock.plan_tensors's layout): CUs from a
  random quadtree per CTB, split into PUs and a TU quadtree, intra and
  inter CUs with coded-block flags, reference indices into lists of
  POCs (the same picture in both lists in part), motion vectors around
  the 4-sample threshold, QPs over the whole range, slices in raster
  order with filtering across slices off in one and deblocking disabled
  in another, tiles, beta and tc offsets of +-12, and planes of
  blocks whose levels walk by small steps, with noise (so that the
  filters' decisions go both ways);
- `sao_synthetic`: one component's plane and its per-CTB SAO maps of
  every type and class, slices, tiles and the 4x4 skip map.

`check_kernels(device, ...)` holds ops/deblock.deblock_frames and
ops/sao.sao_frames against deblock_device_ref and _sao_plane on those
inputs at 1920x1080 (deblocking at 8, 10, 12, 13, 14 and 16 bits, SAO at
8, 10, 13, 14 and 16; at 16 bits the int16 samples above 32767 wrap, as
the JAX pipeline holds them), deblocking also where the kernel's windows
are ragged (1912x1080, 1920x1072, 200x152) or larger than the picture
(40x56, 24x16, 8x8) at 8, 10 and 16 bits and three pictures in one
launch, and on every picture of tests/streams that reaches
deblocking (their SAO on every picture that codes it). The card decode's
stages per picture are timed by TURING_TPU_PIPELINE_TRACE
(decode/device_pipeline.py).

Usage: python -m turingcodec_tpu_torch.tools.loop_filter_check
           [--device cuda]

Any failed check raises.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from turingcodec_tpu_torch.tools.device_enc_check import check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STREAMS = os.path.join(ROOT, "tests", "streams")


def _quadtree(rng, size, min_size, p_split):
    """Squares (y, x, n) tiling a size x size block by random splits."""
    out = []

    def split(y, x, n):
        if n > min_size and rng.random() < p_split:
            h = n // 2
            for dy in (0, h):
                for dx in (0, h):
                    split(y + dy, x + dx, h)
        else:
            out.append((y, x, n))
    split(0, 0, size)
    return out


def deblock_synthetic(rng, h: int, w: int, bd_y: int, bd_c=None,
                      ctb_log2: int = 4, n_slices: int = 4,
                      tiles=(2, 2)):
    """One synthetic picture for deblocking (h, w multiples of 8): returns
    (planes [y, cb, cr] int16, maps: the 11 arrays in plan_tensors's order
    and types, sl: the 6 per-slice arrays, across_tiles False)."""
    bd_c = bd_y if bd_c is None else bd_c
    h4, w4 = h // 4, w // 4
    ctb = 1 << ctb_log2
    hc, wc = -(-h // ctb), -(-w // ctb)
    tu_id = np.full((h4, w4), -1, np.int32)
    pu_id, cu_id = tu_id.copy(), tu_id.copy()
    pred = np.zeros((h4, w4), np.uint8)
    cbf = np.zeros((h4, w4), np.uint8)
    ref_idx = np.full((2, h4, w4), -1, np.int8)
    ref_poc = np.zeros((2, h4, w4), np.int32)
    mv = np.zeros((2, h4, w4, 2), np.int16)
    qp = np.zeros((h4, w4), np.int8)
    # two lists of POCs; index 0 of both lists is the same picture
    pocs = [[8, 4, 0], [8, 12, 16]]
    qp_lo = -6 * (bd_y - 8)
    ids = [0, 0, 0]
    for cy in range(hc):
        for cx in range(wc):
            for (y, x, n) in _quadtree(rng, ctb, 8, 0.6):
                y0, x0 = cy * ctb + y, cx * ctb + x
                if y0 >= h or x0 >= w:
                    continue
                b = np.s_[y0 // 4:(y0 + n) // 4, x0 // 4:(x0 + n) // 4]
                cu_id[b] = ids[0]
                ids[0] += 1
                intra = rng.random() < 0.3
                pred[b] = intra
                qp[b] = rng.integers(qp_lo, 52)
                # PUs: whole, two halves across or along, or four
                k = n // 4
                parts = [(0, 0, k, k)]
                mode = rng.integers(0, 4) if not intra and k > 1 else 0
                if mode == 1:
                    parts = [(0, 0, k // 2, k), (k // 2, 0, k - k // 2, k)]
                elif mode == 2:
                    parts = [(0, 0, k, k // 2), (0, k // 2, k, k - k // 2)]
                elif mode == 3:
                    h2 = k // 2
                    parts = [(py, px, h2, h2) for py in (0, h2)
                             for px in (0, h2)]
                for (py, px, ph, pw) in parts:
                    pb = np.s_[y0 // 4 + py:y0 // 4 + py + ph,
                               x0 // 4 + px:x0 // 4 + px + pw]
                    pu_id[pb] = ids[1]
                    ids[1] += 1
                    if intra:
                        continue
                    use = rng.integers(1, 4)      # L0, L1 or both
                    for lx in (0, 1):
                        if use & (1 << lx):
                            r = int(rng.integers(0, 3))
                            ref_idx[lx][pb] = r
                            ref_poc[lx][pb] = pocs[lx][r]
                            mv[lx][pb] = rng.integers(-6, 7, 2)
                for (ty, tx, tn) in _quadtree(rng, n, 4, 0.5):
                    tb = np.s_[(y0 + ty) // 4:(y0 + ty + tn) // 4,
                               (x0 + tx) // 4:(x0 + tx + tn) // 4]
                    tu_id[tb] = ids[2]
                    ids[2] += 1
                    cbf[tb] = rng.random() < 0.5
    # slices in raster order over the CTBs; tiles as a grid
    n_ctb = hc * wc
    cuts = np.sort(rng.choice(np.arange(1, n_ctb), min(n_slices, n_ctb) - 1,
                              replace=False)) if n_ctb > 1 else []
    slice_idx = np.searchsorted(cuts, np.arange(n_ctb), side="right") \
        .astype(np.int32).reshape(hc, wc)
    ty, tx = tiles
    tile_id = ((np.arange(hc)[:, None] * ty // hc) * tx
               + np.arange(wc)[None, :] * tx // wc).astype(np.int32)
    n_sl = int(slice_idx.max()) + 1
    # across slices off in slice 1, deblocking off in the last of 3 or
    # more; beta and tc offsets of -12 and +12 in slice 0, the other way
    # round in slice 1, random even values in the others
    disabled = np.zeros(n_sl, bool)
    across = np.ones(n_sl, bool)
    if n_sl > 1:
        across[1] = False
    if n_sl > 2:
        disabled[-1] = True
    even = np.arange(-6, 7) * 2
    sl = (disabled, across, rng.choice(even, n_sl).astype(np.int32),
          rng.choice(even, n_sl).astype(np.int32),
          rng.integers(-12, 13, n_sl).astype(np.int32),
          rng.integers(-12, 13, n_sl).astype(np.int32))
    sl[2][0], sl[3][0] = -12, 12
    if n_sl > 1:
        sl[2][1], sl[3][1] = 12, -12

    def plane(hh, ww, bd):
        # blocks whose levels walk by small steps (most edges within beta
        # and tc), a tenth of them at random levels, noise, and 0 / max
        # samples here and there
        hi, scale = (1 << bd) - 1, 1 << (bd - 8)
        step = 8 if hh == h else 4
        hb, wb = -(-hh // step), -(-ww // step)
        level = (rng.integers(-10, 11, (hb, wb)).cumsum(1)
                 + rng.integers(-10, 11, (hb, 1)).cumsum(0)) * scale + hi // 2
        jump = rng.random((hb, wb)) < 0.1
        level[jump] = rng.integers(0, hi + 1, int(jump.sum()))
        p = np.repeat(np.repeat(level, step, 0), step, 1)[:hh, :ww] \
            + rng.integers(0, 3 * scale, (hh, ww))
        extreme = rng.random((hh, ww)) < 0.01
        p[extreme] = rng.choice([0, hi], int(extreme.sum()))
        return np.clip(p, 0, hi).astype(np.int16)
    planes = [plane(h, w, bd_y), plane(h // 2, w // 2, bd_c),
              plane(h // 2, w // 2, bd_c)]
    maps = (tu_id, pu_id, cu_id, pred, cbf, ref_idx, ref_poc, mv, qp,
            slice_idx, tile_id)
    return planes, maps, sl, False


def sao_synthetic(rng, h: int, w: int, bd: int, ctb: int, sub: int = 1,
                  n_slices: int = 3, tiles=(2, 2)):
    """One component's synthetic SAO inputs (sao_frames's arguments
    without the frame axis, numpy): (src, ctb, bd, sub, sao_type,
    sao_class, sao_off, slice_ctb, tile_ctb, enable_s, across_s,
    across_tiles, skip4); every type, band position and edge class."""
    hc, wc = -(-h // ctb), -(-w // ctb)
    sao_type = rng.integers(0, 3, (hc, wc)).astype(np.int32)
    sao_type.flat[:3] = (1, 2, 0)[:hc * wc]     # every type, in slice 0
    sao_class = np.where(sao_type == 1, rng.integers(0, 32, (hc, wc)),
                         rng.integers(0, 4, (hc, wc))).astype(np.int32)
    lim = (1 << (min(bd, 10) - 5)) - 1
    sao_off = rng.integers(-lim, lim + 1, (hc, wc, 4)).astype(np.int32)
    n_ctb = hc * wc
    cuts = np.sort(rng.choice(np.arange(1, n_ctb), min(n_slices, n_ctb) - 1,
                              replace=False)) if n_ctb > 1 else []
    slice_ctb = np.searchsorted(cuts, np.arange(n_ctb), side="right") \
        .astype(np.int32).reshape(hc, wc)
    ty, tx = tiles
    tile_ctb = ((np.arange(hc)[:, None] * ty // hc) * tx
                + np.arange(wc)[None, :] * tx // wc).astype(np.int32)
    n_sl = int(slice_ctb.max()) + 1
    enable = np.ones(n_sl, bool)
    across = rng.random(n_sl) < 0.5
    if n_sl > 1:
        enable[1] = False
        across[0] = False
    k = 4 // sub
    skip4 = rng.random((-(-h // k), -(-w // k))) < 0.05
    hi = (1 << bd) - 1
    # plateaus with noise: local minima, maxima, edges and flat runs
    level = rng.integers(0, hi + 1, (-(-h // 4), -(-w // 4)))
    src = np.repeat(np.repeat(level, 4, 0), 4, 1)[:h, :w] \
        + rng.integers(-2, 3, (h, w))
    src = np.clip(src, 0, hi).astype(np.int16)
    return (src, ctb, bd, sub, sao_type, sao_class, sao_off, slice_ctb,
            tile_ctb, enable, across, bool(rng.random() < 0.5), skip4)


def sao_picture_synthetic(rng, h: int, w: int, bd_y: int, bd_c=None,
                          ctb: int = 64, chroma: bool = True,
                          n_slices: int = 3, tiles=(2, 2)):
    """One synthetic SAO-coded picture as the decoder hands it to
    sao_picture_device (h, w multiples of 8): (plan, geom, [y, cb, cr]
    int16 deblocked planes), plan and geom namespaces with the fields SAO
    reads. Every type, band position and edge class in every component
    (Cr sharing Cb's type and edge class), slices in raster order with
    luma SAO off in slice 1 and chroma SAO off in slice 2, filtering
    across slices off in some, a CTB no slice covers (index -1), tiles
    with filtering across them on or off, PCM and transquant-bypass
    blocks; monochrome (chroma_array_type 0) when chroma is False."""
    from types import SimpleNamespace as NS
    bd_c = bd_y if bd_c is None else bd_c
    hc, wc = -(-h // ctb), -(-w // ctb)
    n_ctb = hc * wc
    sao_type = rng.integers(0, 3, (hc, wc, 3)).astype(np.uint8)
    sao_type[:, :, 2] = sao_type[:, :, 1]
    sao_type.reshape(-1, 3)[:3] = np.array([[1, 2, 2], [2, 1, 1],
                                            [0, 0, 0]])[:n_ctb]
    sao_class = np.where(sao_type == 1, rng.integers(0, 32, (hc, wc, 3)),
                         rng.integers(0, 4, (hc, wc, 3))).astype(np.uint8)
    sao_class[:, :, 2] = np.where(sao_type[:, :, 2] == 2, sao_class[:, :, 1],
                                  sao_class[:, :, 2])
    offsets = np.zeros((hc, wc, 3, 4), np.int32)
    for c, bd in enumerate((bd_y, bd_c, bd_c)):
        lim = (1 << (min(bd, 10) - 5)) - 1
        offsets[:, :, c] = rng.integers(-lim, lim + 1, (hc, wc, 4)) \
            << (bd - min(bd, 10))
    cuts = np.sort(rng.choice(np.arange(1, n_ctb), min(n_slices, n_ctb) - 1,
                              replace=False)) if n_ctb > 1 else []
    slice_idx = np.searchsorted(cuts, np.arange(n_ctb), side="right") \
        .astype(np.int32).reshape(hc, wc)
    if n_ctb > 4:
        slice_idx.flat[-1] = -1
    ty, tx = tiles
    tile_id = ((np.arange(hc)[:, None] * ty // hc) * tx
               + np.arange(wc)[None, :] * tx // wc).astype(np.int32)
    n_sl = min(n_slices, n_ctb)
    across = rng.random(n_sl) < 0.5
    across[0] = False
    shs = [NS(slice_loop_filter_across_slices_enabled_flag=int(across[i]),
              slice_sao_luma_flag=int(i != 1),
              slice_sao_chroma_flag=int(i != 2)) for i in range(n_sl)]
    h4, w4 = h // 4, w // 4
    sps = NS(pic_height_in_luma_samples=h, pic_width_in_luma_samples=w,
             pic_height_in_ctbs_y=hc, pic_width_in_ctbs_y=wc, ctb_size_y=ctb,
             ctb_log2_size_y=ctb.bit_length() - 1, bit_depth_y=bd_y,
             bit_depth_c=bd_c, chroma_array_type=int(chroma),
             pcm_enabled_flag=1, pcm_loop_filter_disabled_flag=1)
    pps = NS(loop_filter_across_tiles_enabled_flag=int(rng.random() < 0.5),
             transquant_bypass_enabled_flag=1)
    plan = NS(sps=sps, pps=pps, slice_headers=shs, slice_idx=slice_idx,
              sao_type=sao_type, sao_class=sao_class, sao_offsets=offsets,
              pcm_flag=rng.random((h4, w4)) < 0.03,
              tq_bypass=rng.random((h4, w4)) < 0.03)
    geom = NS(tile_id=tile_id, num_tiles=ty * tx)

    def plane(hh, ww, bd):
        # plateaus with noise: local minima, maxima, edges and flat runs
        hi = (1 << bd) - 1
        level = rng.integers(0, hi + 1, (-(-hh // 4), -(-ww // 4)))
        p = np.repeat(np.repeat(level, 4, 0), 4, 1)[:hh, :ww] \
            + rng.integers(-2, 3, (hh, ww))
        return np.clip(p, 0, hi).astype(np.int16)
    planes = [plane(h, w, bd_y), plane(h // 2, w // 2, bd_c),
              plane(h // 2, w // 2, bd_c)]
    return plan, geom, planes


def tensors(arrays, device):
    """numpy arrays or tensors (nested in tuples) as tensors on `device`,
    each with a leading frame axis of 1; other values as they are."""
    import torch
    if isinstance(arrays, (tuple, list)):
        return type(arrays)(tensors(a, device) for a in arrays)
    if isinstance(arrays, np.ndarray):
        arrays = torch.from_numpy(np.ascontiguousarray(arrays))
    if isinstance(arrays, torch.Tensor):
        return arrays[None].to(device)
    return arrays


def check_kernels(device, log=print):
    """deblock_frames and sao_frames on `device` against their plain
    versions: the synthetic 1080p cases, then every picture of
    tests/streams that reaches deblocking (before and after SAO where it
    codes SAO). Returns (max |diff| of each, the names compared)."""
    import torch

    from turingcodec_tpu_torch.ops import deblock as db
    from turingcodec_tpu_torch.ops import sao
    from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures

    def same(name, got, want):
        check(all(g.shape == w_.shape and torch.equal(g.cpu(), w_.cpu())
                  for g, w_ in zip(got, want)),
              f"kernel differs from its plain version: {name}")
        return max(int((g.cpu().long() - w_.cpu().long()).abs().max())
                   for g, w_ in zip(got, want))

    rng = np.random.default_rng(19)
    errs = {"deblock": 0, "sao": 0}
    names = {"deblock": [], "sao": []}

    def deblock(name, planes, maps, sl, across, ctb_log2, bd_y, bd_c):
        got = db.deblock_frames(*tensors((planes[0], planes[1], planes[2],
                                          maps, sl), device), ctb_log2,
                                bd_y, bd_c, across)
        want = db.deblock_device_ref(
            *(torch.as_tensor(np.asarray(a)) for a in planes),
            tuple(torch.as_tensor(np.asarray(m)) for m in maps),
            tuple(torch.as_tensor(np.asarray(v)) for v in sl),
            ctb_log2, bd_y, bd_c, across)
        errs["deblock"] = max(errs["deblock"], same(
            name, [g[0] for g in got], want))
        names["deblock"].append(name)

    def on(a):
        if isinstance(a, (list, tuple)):
            return type(a)(on(x) for x in a)
        return a.to(device) if isinstance(a, torch.Tensor) else a

    def sao_one(name, args):
        """args: sao_frames's, with the frame axis, on the CPU; the plane
        through the one-component launch and, for luma, the
        three-component launcher's monochrome form"""
        want = sao.sao_frames(*args)
        got = [sao.sao_frames(*on(args))]
        if args[3] == 1:
            got.append(sao.sao_picture_frames(
                [on(args[0])], args[1], args[2], args[2],
                *(on(a[:, None]) for a in args[4:7]), *on(args[7:9]),
                on(args[9][:, None]), *on(args[10:]))[0])
        errs["sao"] = max(errs["sao"], same(name, got, [want] * len(got)))
        names["sao"].append(name)

    def sao_picture(name, plan, geom, planes):
        """a picture through the three-component launch (one for every
        component) and through one launch per component"""
        n = 3 if plan.sps.chroma_array_type else 1
        maps = sao._picture_maps(plan, geom, "cpu")
        srcs = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes[:n]]
        want = sao.sao_picture_frames(*sao.sao_picture_args(plan, maps, srcs))
        dmaps = {k: on(v) for k, v in maps.items()}
        before = sao.launches
        got = sao.sao_picture_frames(*sao.sao_picture_args(plan, dmaps,
                                                           on(srcs)))
        check(device.type != "cuda" or sao.launches - before == 1,
              f"{name}: the picture took {sao.launches - before} launches")
        got += [sao.sao_frames(*sao.sao_ctb_args(plan, dmaps, c, on(srcs[c])))
                for c in range(n)]
        errs["sao"] = max(errs["sao"], same(name, got, want * 2))
        names["sao"].append(name)

    h, w = 1080, 1920
    # 16 bits under the int16 convention: samples above 32767 wrap
    for bd, ctb_log2 in ((8, 4), (10, 5), (12, 6), (13, 4), (14, 5),
                         (16, 6)):
        planes, maps, sl, across = deblock_synthetic(rng, h, w, bd,
                                                     ctb_log2=ctb_log2)
        deblock(f"deblock synthetic {w}x{h} {bd}-bit ctb {1 << ctb_log2}",
                planes, maps, sl, across, ctb_log2, bd, bd)
    # the kernel's windows where they are ragged (sides no multiple of 16
    # or 64) or larger than the picture (56x40, 16x24, 8x8 with no edge)
    for hr, wr in ((1080, 1912), (1072, 1920), (152, 200), (56, 40),
                   (16, 24), (8, 8)):
        for bd in (8, 10, 16):
            planes, maps, sl, across = deblock_synthetic(rng, hr, wr, bd,
                                                         ctb_log2=4)
            deblock(f"deblock synthetic {wr}x{hr} {bd}-bit", planes, maps,
                    sl, across, 4, bd, bd)
    # three pictures in one launch, each with its own across-tiles flag
    pics = [deblock_synthetic(rng, 136, 200, 10, ctb_log2=5)
            for _ in range(3)]
    flags = torch.tensor([True, False, True])
    got = db.deblock_frames(
        *(torch.stack([torch.from_numpy(p[0][k]) for p in pics]).to(device)
          for k in range(3)),
        tuple(torch.stack([torch.from_numpy(np.ascontiguousarray(p[1][k]))
                           for p in pics]).to(device) for k in range(11)),
        tuple(torch.stack([torch.from_numpy(p[2][k]) for p in pics])
              .to(device) for k in range(6)),
        5, 10, 10, flags.to(device))
    for i, (planes, maps, sl, _) in enumerate(pics):
        want = db.deblock_device_ref(
            *(torch.from_numpy(a) for a in planes),
            tuple(torch.from_numpy(np.ascontiguousarray(m)) for m in maps),
            tuple(torch.from_numpy(v) for v in sl), 5, 10, 10,
            bool(flags[i]))
        errs["deblock"] = max(errs["deblock"], same(
            f"deblock_frames picture {i} of 3", [g[i] for g in got], want))
    names["deblock"].append("deblock_frames, 3 pictures 200x136 10-bit")
    # SAO: 1080p pictures at every CTB size, mixed luma and chroma depths,
    # ragged sides (no multiple of 64, or of 8 in the chroma), pictures
    # smaller than one window, monochrome, and more slices than the kernel
    # stages (its per-slice flags then read from device memory)
    for bd_y, bd_c, ctb, hh, ww, mono, n_sl in (
            (8, 8, 64, h, w, False, 3), (10, 10, 32, h, w, False, 5),
            (13, 13, 16, h, w, False, 9), (14, 14, 64, h, w, False, 3),
            (16, 16, 32, h, w, False, 4), (8, 10, 16, h, w, False, 6),
            (12, 8, 32, h, w, False, 3), (8, 8, 16, 1076, 1916, False, 7),
            (10, 10, 64, 136, 200, False, 3), (8, 8, 16, 16, 24, False, 2),
            (10, 10, 32, h, w, True, 4), (8, 8, 16, h, w, False, 300)):
        sao_picture(f"sao synthetic {ww}x{hh} {bd_y}/{bd_c}-bit ctb {ctb}"
                    f"{' monochrome' if mono else ''}, {n_sl} slices",
                    *sao_picture_synthetic(rng, hh, ww, bd_y, bd_c, ctb,
                                           not mono, n_sl))
    # single planes: odd sides, and each chroma plane alone
    for bd, (hh, ww), ctb, sub in ((8, (1079, 1913), 16, 1),
                                   (16, (37, 53), 8, 1),
                                   (10, (540, 960), 32, 2),
                                   (14, (67, 101), 8, 2)):
        sao_one(f"sao synthetic plane {ww}x{hh} {bd}-bit ctb {ctb} sub {sub}",
                tensors(sao_synthetic(rng, hh, ww, bd, ctb, sub), "cpu"))
    # three pictures in one launch, each with its own across-tiles flag
    pics = [sao_picture_synthetic(rng, 136, 200, 10, 10, 32)
            for _ in range(3)]
    one = [sao.sao_picture_args(
        p[0], sao._picture_maps(p[0], p[1], "cpu"),
        [torch.from_numpy(x) for x in p[2]]) for p in pics]
    flags = torch.tensor([True, False, True])
    stacked = ([torch.cat([a[0][c] for a in one]) for c in range(3)],
               *one[0][1:4], *(torch.cat([a[i] for a in one])
                               for i in range(4, 11)),
               flags, torch.cat([a[12] for a in one]))
    got = sao.sao_picture_frames(*on(stacked))
    for i, a in enumerate(one):
        want = sao.sao_picture_frames(*a[:11], bool(flags[i]), a[12])
        errs["sao"] = max(errs["sao"], same(
            f"sao_picture_frames picture {i} of 3",
            [g[i:i + 1] for g in got], want))
    names["sao"].append("sao_picture_frames, 3 pictures 200x136 10-bit")
    log(f"kernel vs plain, deblock on {len(names['deblock'])} synthetic "
        f"cases (1080p, ragged windows, a batch of 3) and sao on "
        f"{len(names['sao'])} synthetic pictures and planes (pictures "
        f"through the three-component and the one-component launches, a "
        f"batch of 3): equal")

    from turingcodec_tpu_torch.ops.deblock import plan_tensors
    n_db = n_sao = 0
    for fn in sorted(f for f in os.listdir(STREAMS) if f.endswith(".hevc")):
        with open(os.path.join(STREAMS, fn), "rb") as fh:
            pics = capture_pictures(fh.read())
        for i, p in enumerate(pics):
            plan, geom, sps = p["plan"], p["geom"], p["plan"].sps
            if sps.chroma_array_type != 1:
                continue
            maps, sl, across = plan_tensors(plan, geom, "cpu")
            deblock(f"deblock {fn} picture {i}", p["pre"], maps, sl, across,
                    int(sps.ctb_log2_size_y), int(sps.bit_depth_y),
                    int(sps.bit_depth_c))
            n_db += 1
            if p["sao"] is None:
                continue
            sao_picture(f"sao {fn} picture {i}", plan, geom, p["post"])
            n_sao += 1
    log(f"kernel vs plain, deblock on {n_db} pictures and sao on {n_sao} "
        f"pictures of tests/streams: equal")
    return errs, names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device")
    check_kernels(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
