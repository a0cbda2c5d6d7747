"""Encoder pre-analysis stages on a torch device (EncoderConfig.device).

The encoder's per-picture data-parallel analysis runs as torch code on the
chosen device and feeds the sequential host RDO exactly the integers its
own kernels would have produced, so the bitstream is byte-identical with
the host path (integer arithmetic, same tie-breaks):

- lowres pre-ME seed fields (enc_core lowres_prepass /
  inter_search._lowres_seed_field twins): quarter-res exhaustive +/-8 SAD
  per 16x16 block with cost (SAD<<2)+|dx|+|dy| and scan-order tie-breaks,
  then a half-res +/-2 refinement;
- the dense full-pel +/-8 ME field around the seeds (enc_core
  dense_search_rows twin), through the hand-written kernel
  ops/dense_me.dense_me_sweep, which reads the planes directly, with
  every block's 17x17 SAD surface unless TC_NO_ME_SURF is set (the
  switch the host prepass reads): the full-pel search reads its aligned
  probes from it on both paths;
- the 15 subpel planes of each reference (enc_core sp_build_plane twin);
- the source-referenced 35-mode rank-SATD tables (intra_search
  _mode_satds twin).

Every scan with a strict-improvement tie-break becomes a min over the
packed key (cost << 9) | k, k the scan position, so the result does not
depend on the reduction order. The host planes stay numpy (the encoder's
caches key by their id()); each call uploads them and returns numpy int32.
The numpy host twins (subpel_planes_host, rank_satd_tables_host) are the
oracles of the device versions.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from turingcodec_tpu_torch.ops.dense_me import dense_me_sweep, edge_pad
from turingcodec_tpu_torch.ops.metrics import _wht_last

_STATIC = {}  # per-geometry index tensors, keyed by shape and device
# SAD surfaces computed for the encoder's install since import (or since a
# caller reset it to 0): one per distinct reference plane of an inter
# picture, which both lists share when they hold the same picture
surfaces = 0


def resolve_device(device) -> Optional[torch.device]:
    """EncoderConfig.device or Decoder's device -> the torch device of the
    device stages, or None for the host path. A CUDA device without a
    usable card raises: the stages never fall back to the host."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def device_enc_enabled(device) -> bool:
    """Whether the analysis stage runs on `device` (TC_NO_LOWRES turns the
    whole pre-analysis off, as on the host path)."""
    return device is not None and not os.environ.get("TC_NO_LOWRES")


def upload(plane: np.ndarray, device, dtype=torch.int32) -> torch.Tensor:
    """A host sample plane as a `dtype` tensor on `device` (sent as
    int16)."""
    return torch.from_numpy(np.ascontiguousarray(plane, np.int16)).to(
        device).to(dtype)


def _first_min(cost: torch.Tensor) -> torch.Tensor:
    """Index along dim 0 of the first minimum of non-negative integer
    costs: the min of the packed key (cost << 9) | k (dim 0 <= 512)."""
    n = cost.shape[0]
    k = torch.arange(n, device=cost.device).reshape(
        (n,) + (1,) * (cost.dim() - 1))
    return ((cost.to(torch.int64) << 9) | k).min(0).values & 511


def _lowres_plane(src, f, b, wb, hb, border):
    """Twin of enc_core lowres_plane<F,B>: edge-clamped decimation by
    rounded mean, padded to (hb*b, wb*b) + border."""
    h, w = src.shape
    lw, lh = -(-w // f), -(-h // f)
    p = edge_pad(src, 0, lh * f - h, 0, lw * f - w)
    lr = (p.reshape(lh, f, lw, f).sum((1, 3), dtype=torch.int32)
          + f * f // 2) // (f * f)
    # two edge pads compose into one clamp to the decimated plane
    return edge_pad(lr, border, hb * b - lh + border,
                    border, wb * b - lw + border)


def block_dims(w: int, h: int):
    """(wb, hb): the grid of 16x16 blocks the seed and dense fields cover
    (4x4 blocks of the quarter-res plane, edge-padded)."""
    lw, lh = -(-w // 4), -(-h // 4)
    return -(-lw // 4), -(-lh // 4)


def seed_field(orig: torch.Tensor, ref: torch.Tensor, wb: int, hb: int):
    """(orig, ref) int16 or int32 planes -> (hb, wb, 2) int32 seed MVs."""
    dev = orig.device
    cur4 = _lowres_plane(orig, 4, 4, wb, hb, 0)
    ref4 = _lowres_plane(ref, 4, 4, wb, hb, 8)
    # quarter-res exhaustive +/-8: all 289 windows at once
    win = ref4.unfold(0, hb * 4, 1).unfold(1, wb * 4, 1)  # (17,17,H,W)
    sad = (cur4 - win).abs().reshape(17, 17, hb, 4, wb, 4).sum(
        (3, 5), dtype=torch.int32)
    a = torch.arange(-8, 9, device=dev, dtype=torch.int32).abs()
    cost = (sad << 2) + (a[:, None] + a[None, :])[:, :, None, None]
    k = _first_min(cost.reshape(289, hb, wb))
    sdy, sdx = k // 17 - 8, k % 17 - 8

    # half-res +/-2 refinement around (2*sdx, 2*sdy) half-pels
    cur8 = _lowres_plane(orig, 2, 8, wb, hb, 0)
    ref8 = _lowres_plane(ref, 2, 8, wb, hb, 24)
    cb = cur8.reshape(hb, 8, wb, 8).permute(0, 2, 1, 3)
    by = torch.arange(hb, device=dev)[:, None]
    bx = torch.arange(wb, device=dev)[None, :]
    chy, chx = 2 * sdy, 2 * sdx
    d = torch.arange(-2, 3, device=dev)
    ay = torch.arange(8, device=dev)
    ys = ((by * 8 + chy + 24)[None, None, :, :, None, None]
          + d[:, None, None, None, None, None]
          + ay[None, None, None, None, :, None])
    xs = ((bx * 8 + chx + 24)[None, None, :, :, None, None]
          + d[None, :, None, None, None, None]
          + ay[None, None, None, None, None, :])
    sad = (cb - ref8[ys, xs]).abs().sum((-2, -1), dtype=torch.int32)
    sx = 2 * (chx + d[None, :, None, None])
    sy = 2 * (chy + d[:, None, None, None])
    cost = (sad << 2) + sx.abs() + sy.abs()          # (5, 5, hb, wb)
    k = _first_min(cost.reshape(25, hb, wb))
    bsx = 2 * (chx + k % 5 - 2)
    bsy = 2 * (chy + k // 5 - 2)
    return torch.stack([bsx, bsy], -1).to(torch.int32)


def _dense_stage(orig, ref, seeds, w, h, wb, hb, want_surf=False):
    """Twin of enc_core dense_search_rows: per 16x16 block, the exhaustive
    +/-8 full-pel SAD winner around the lowres seed, through the
    dense_me_sweep kernel. Returns ((hb, wb, 2) MVs, (hb, wb) SADs), and
    with want_surf also the (hb*wb, 289) SAD surface."""
    res = dense_me_sweep(orig, ref, seeds, w, h, wb, hb, want_surf)
    res, surf = res if want_surf else (res, None)
    off = res[:, :2].reshape(hb, wb, 2)
    out = (seeds + off, res[:, 2].reshape(hb, wb))
    return out + (surf,) if want_surf else out


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int32).cpu().numpy()


def analysis_device(orig_y: np.ndarray, ref_y: np.ndarray, device,
                    want_surf: bool = False):
    """One reference plane's (seed, dense, sad) fields on `device`:
    ((hb, wb, 2), (hb, wb, 2), (hb, wb)) int32 numpy plus wb, hb —
    integer-exact with the host lowres_prepass + dense_prepass. With
    want_surf, a sixth value: the dense sweep's (hb*wb, 289) int32 SAD
    surface, native.dense_analysis's out_surf."""
    h, w = orig_y.shape
    wb, hb = block_dims(w, h)
    orig = upload(orig_y, device, torch.int16)
    ref = upload(ref_y, device, torch.int16)
    seeds = seed_field(orig, ref, wb, hb)
    dense = _dense_stage(orig, ref, seeds, w, h, wb, hb, want_surf)
    out = (_np32(seeds), _np32(dense[0]), _np32(dense[1]), wb, hb)
    return out + (_np32(dense[2]),) if want_surf else out


def seed_field_device(orig_y: np.ndarray, ref_y: np.ndarray, device):
    """One reference plane's seed field on `device`: ((hb, wb, 2) int32
    numpy, wb, hb) — the exact value of inter_search._lowres_seed_field /
    enc_core lowres_prepass."""
    h, w = orig_y.shape
    wb, hb = block_dims(w, h)
    seeds = seed_field(upload(orig_y, device, torch.int16),
                       upload(ref_y, device, torch.int16), wb, hb)
    return _np32(seeds), wb, hb


SP_P = 28   # stored-plane pad (enc_core SP_P)
SP_EXT2 = 36  # edge pad so every clamped tap read is a plain slice


def _subpel_planes(ref: torch.Tensor, bd: int) -> torch.Tensor:
    """int32 ref plane -> (15, h+2*SP_P, w+2*SP_P) int16: the 15 fractional
    luma positions interpolated over the padded grid, each value bit-equal
    to enc_core sp_build_plane (edge-replicated padding == per-sample
    coordinate clamping; same >>shift1 / >>6 arithmetic)."""
    from turingcodec_tpu_torch.hevc.tables import LUMA_FILTER
    filt = np.asarray(LUMA_FILTER, np.int32)  # (4 phases, 8 taps)
    h, w = ref.shape
    shift1 = bd - 8
    pw, ph = w + 2 * SP_P, h + 2 * SP_P
    pwe, phe = w + 2 * (SP_P + 4), h + 2 * (SP_P + 4)
    ext2 = edge_pad(ref, SP_EXT2, SP_EXT2, SP_EXT2, SP_EXT2)
    # H-filtered intermediates for xf=1..3 over the full ext grid (rows
    # phe so the 2D V pass can reach its taps)
    hplanes = {}
    for xf in (1, 2, 3):
        acc = sum(int(filt[xf][k]) * ext2[4:4 + phe, 1 + k:1 + k + pwe]
                  for k in range(8))
        hplanes[xf] = acc >> shift1
    out = []
    for yf in range(4):
        for xf in range(4):
            if xf == 0 and yf == 0:
                continue
            if yf == 0:
                p = hplanes[xf][4:4 + ph, 4:4 + pw]
            elif xf == 0:
                acc = sum(int(filt[yf][k]) * ext2[5 + k:5 + k + ph, 8:8 + pw]
                          for k in range(8))
                p = acc >> shift1
            else:
                acc = sum(int(filt[yf][k])
                          * hplanes[xf][1 + k:1 + k + ph, 4:4 + pw]
                          for k in range(8))
                p = acc >> 6
            out.append(p.to(torch.int16))
    return torch.stack(out)


def subpel_planes_device(ref_y: np.ndarray, bd: int, device) -> np.ndarray:
    """The 15 subpel planes of one reference plane, computed on `device`;
    (15, h+2*SP_P, w+2*SP_P) int16 numpy, exact sp_build_plane values."""
    return _subpel_planes(upload(ref_y, device), bd).cpu().numpy()


def subpel_planes_host(ref_y: np.ndarray, bd: int = 8) -> np.ndarray:
    """Vectorized numpy twin of subpel_planes_device / sp_build_plane
    (full-plane oracle for the real-chip exactness check)."""
    from turingcodec_tpu_torch.hevc.tables import LUMA_FILTER
    filt = np.asarray(LUMA_FILTER, np.int32)
    h, w = ref_y.shape
    shift1 = bd - 8
    pw, ph = w + 2 * SP_P, h + 2 * SP_P
    pwe, phe = w + 2 * (SP_P + 4), h + 2 * (SP_P + 4)
    ext2 = np.pad(ref_y.astype(np.int32), SP_EXT2, "edge")
    hplanes = {}
    for xf in (1, 2, 3):
        acc = sum(int(filt[xf][k]) * ext2[4:4 + phe, 1 + k:1 + k + pwe]
                  for k in range(8))
        hplanes[xf] = acc >> shift1 if shift1 else acc
    out = []
    for yf in range(4):
        for xf in range(4):
            if xf == 0 and yf == 0:
                continue
            if yf == 0:
                p = hplanes[xf][4:4 + ph, 4:4 + pw]
            elif xf == 0:
                acc = sum(int(filt[yf][k])
                          * ext2[5 + k:5 + k + ph, 8:8 + pw]
                          for k in range(8))
                p = acc >> shift1 if shift1 else acc
            else:
                acc = sum(int(filt[yf][k])
                          * hplanes[xf][1 + k:1 + k + ph, 4:4 + pw]
                          for k in range(8))
                p = acc >> 6
            out.append(p.astype(np.int16))
    return np.stack(out)


def _rank_grid_refs(plane, zscan, n, bd):
    """Batched source-referenced intra reference samples for every
    in-picture n-aligned block: returns vals (hn*wn, 4n+1) int32 in scan
    order (left bottom-up, corner, top), with spec 8.4.4.2.2
    availability substitution (z-scan positional availability — the
    simple single-slice/no-tile case the prepass supports)."""
    h, w = plane.shape
    hn, wn = h // n, w // n
    m = 4 * n + 1
    tx = np.empty(m, np.int32)
    ty = np.empty(m, np.int32)
    tx[:2 * n + 1] = -1
    tx[2 * n + 1:] = np.arange(2 * n)
    ty[:2 * n] = 2 * n - 1 - np.arange(2 * n)
    ty[2 * n:] = -1
    bx = (np.arange(wn) * n)[None, :, None]
    by = (np.arange(hn) * n)[:, None, None]
    px = bx + tx[None, None, :]
    py = by + ty[None, None, :]
    inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    pxc = np.clip(px, 0, w - 1)
    pyc = np.clip(py, 0, h - 1)
    zcur = zscan[by[:, :, 0] >> 2, bx[:, :, 0] >> 2][:, :, None]
    ok = inb & (zscan[pyc >> 2, pxc >> 2] <= zcur)
    vals = plane[pyc, pxc].astype(np.int32)
    vals = vals.reshape(-1, m)
    ok = ok.reshape(-1, m)
    mid = 1 << (bd - 1)
    any_ok = ok.any(axis=1)
    first = np.argmax(ok, axis=1)
    b = np.arange(vals.shape[0])
    vals[:, 0] = np.where(ok[:, 0], vals[:, 0], vals[b, first])
    ok[:, 0] = True
    vals = np.where(ok, vals, 0)
    src = np.where(ok, np.arange(m)[None, :], 0)
    np.maximum.accumulate(src, axis=1, out=src)
    vals = vals[b[:, None], src]
    vals = np.where(any_ok[:, None], vals, mid)
    return vals


def _filter_grid_refs(vals, n, strong, bd):
    """Batched spec 8.4.4.2.3 reference filtering of scan-order vals
    (B, 4n+1): [1 2 1] smoothing, with the strong bilinear variant at
    n == 32 when the flatness thresholds pass."""
    B, m = vals.shape
    co = vals[:, 2 * n]
    rl = vals[:, :2 * n][:, ::-1]  # rl[i] = p[-1][i] top-down
    rt = vals[:, 2 * n + 1:]
    ft = np.empty_like(rt)
    fl = np.empty_like(rl)
    ft[:, 0] = (co + 2 * rt[:, 0] + rt[:, 1] + 2) >> 2
    fl[:, 0] = (co + 2 * rl[:, 0] + rl[:, 1] + 2) >> 2
    ft[:, 1:2 * n - 1] = (rt[:, :2 * n - 2] + 2 * rt[:, 1:2 * n - 1]
                          + rt[:, 2:] + 2) >> 2
    fl[:, 1:2 * n - 1] = (rl[:, :2 * n - 2] + 2 * rl[:, 1:2 * n - 1]
                          + rl[:, 2:] + 2) >> 2
    ft[:, 2 * n - 1] = rt[:, 2 * n - 1]
    fl[:, 2 * n - 1] = rl[:, 2 * n - 1]
    fc = (rl[:, 0] + 2 * co + rt[:, 0] + 2) >> 2
    if strong and n == 32:
        t1 = np.abs(co + rt[:, 2 * n - 1] - 2 * rt[:, n - 1])
        t2 = np.abs(co + rl[:, 2 * n - 1] - 2 * rl[:, n - 1])
        is_str = (t1 < (1 << (bd - 5))) & (t2 < (1 << (bd - 5)))
        i = np.arange(63)
        st = ((63 - i)[None, :] * co[:, None]
              + (i + 1)[None, :] * rt[:, 63][:, None] + 32) >> 6
        sl = ((63 - i)[None, :] * co[:, None]
              + (i + 1)[None, :] * rl[:, 63][:, None] + 32) >> 6
        ft[:, :63] = np.where(is_str[:, None], st, ft[:, :63])
        fl[:, :63] = np.where(is_str[:, None], sl, fl[:, :63])
        ft[:, 63] = np.where(is_str, rt[:, 63], ft[:, 63])
        fl[:, 63] = np.where(is_str, rl[:, 63], fl[:, 63])
        fc = np.where(is_str, co, fc)
    out = np.empty_like(vals)
    out[:, :2 * n] = fl[:, ::-1]
    out[:, 2 * n] = fc
    out[:, 2 * n + 1:] = ft
    return out


def _grid_mode_satds(orig_blocks, vals, fvals, n, bd):
    """(B, n, n) originals + scan-order refs -> (B, 35) SATDs, matching
    intra_search._mode_satds (per-mode filtered/unfiltered choice, no
    edge filters in the ranking predictions)."""
    from turingcodec_tpu_torch.decode.reconstruct import _HVD_THRES
    from turingcodec_tpu_torch.encode.sweep import _h4, _h8, _stacked_tables
    B = vals.shape[0]
    rl = vals[:, :2 * n][:, ::-1]
    co = vals[:, 2 * n]
    rt = vals[:, 2 * n + 1:]
    x = np.arange(n)
    log2n = int(n).bit_length() - 1
    out = np.empty((B, 35), np.int64)
    block = 8 if n >= 8 else 4
    hb = _h8() if block == 8 else _h4()
    d0 = orig_blocks.astype(np.int32)

    def satd(preds):  # (B, M, n, n) -> (B, M)
        mm = preds.shape[1]
        d = d0[:, None] - preds
        bh = n // block
        d = d.reshape(B, mm, bh, block, bh, block).transpose(
            0, 1, 2, 4, 3, 5)
        t = hb @ d @ hb
        s = np.abs(t).sum(axis=(4, 5))
        s = (s + 2) >> 2 if block == 8 else (s + 1) >> 1
        return s.sum(axis=(2, 3)).astype(np.int64)

    use_f = np.zeros(35, bool)
    if n > 4:
        thres = _HVD_THRES[n]
        for mode in range(35):
            if mode == 1:
                continue
            if mode != 0 and min(abs(mode - 26), abs(mode - 10)) <= thres:
                continue
            use_f[mode] = True

    frl = fvals[:, :2 * n][:, ::-1] if fvals is not None else rl
    fco = fvals[:, 2 * n] if fvals is not None else co
    frt = fvals[:, 2 * n + 1:] if fvals is not None else rt

    # planar + DC from the per-mode-appropriate refs
    def planar(rt_, rl_):
        return (((n - 1 - x)[None, None, :] * rl_[:, :n, None]
                 + (x + 1)[None, None, :] * rt_[:, n][:, None, None]
                 + (n - 1 - x)[None, :, None] * rt_[:, None, :n]
                 + (x + 1)[None, :, None] * rl_[:, n][:, None, None]
                 + n) >> (log2n + 1)).astype(np.int32)

    p0 = planar(frt, frl) if use_f[0] else planar(rt, rl)
    rtd, rld = (frt, frl) if use_f[1] else (rt, rl)
    dc = ((rtd[:, :n].sum(axis=1) + rld[:, :n].sum(axis=1) + n)
          >> (log2n + 1))
    p1 = np.broadcast_to(dc[:, None, None].astype(np.int32),
                         (B, n, n)).copy()
    out[:, 0] = satd(p0[:, None])[:, 0]
    out[:, 1] = satd(p1[:, None])[:, 0]

    # angular modes via the stacked gather tables, one ext per variant
    pos0, fact, neg = _stacked_tables(n)

    def build_ext(rt_, rl_, co_):
        ext = np.empty((B, 33, 3 * n + 2), np.int32)
        ext[:, :16, :n] = np.where(neg[None, :16] < 0, co_[:, None, None],
                                   rt_[:, np.maximum(neg[:16], 0)])
        ext[:, 16:, :n] = np.where(neg[None, 16:] < 0, co_[:, None, None],
                                   rl_[:, np.maximum(neg[16:], 0)])
        ext[:, :, n] = co_[:, None]
        ext[:, :16, n + 1:3 * n + 1] = rl_[:, None, :2 * n]
        ext[:, 16:, n + 1:3 * n + 1] = rt_[:, None, :2 * n]
        ext[:, :16, 3 * n + 1] = rl_[:, 2 * n - 1][:, None]
        ext[:, 16:, 3 * n + 1] = rt_[:, 2 * n - 1][:, None]
        return ext.reshape(B, -1)

    ext_u = build_ext(rt, rl, co)
    ext_f = build_ext(frt, frl, fco) if n > 4 else ext_u
    bidx = np.arange(B)[:, None, None, None]
    pf = pos0[None]
    gu = ext_u[bidx, pf]
    g1u = ext_u[bidx, pf + 1]
    pu = ((32 - fact[None]) * gu + fact[None] * g1u + 16) >> 5
    if n > 4:
        gf = ext_f[bidx, pf]
        g1f = ext_f[bidx, pf + 1]
        pfa = ((32 - fact[None]) * gf + fact[None] * g1f + 16) >> 5
        sel = use_f[2:][None, :, None, None]
        pang = np.where(sel, pfa, pu)
    else:
        pang = pu
    out[:, 2:] = satd(pang.astype(np.int32))
    return out


def rank_satd_tables_host(plane, zscan, bd, strong, sizes=(4, 8, 16, 32)):
    """Source-referenced 35-mode SATD tables for every aligned block of
    each size: {n: (hn, wn, 35) int32}. The exact integers the in-loop
    rank computes at those positions (intra_search._mode_satds /
    enc_core rank_modes sweep with source refs)."""
    plane = np.asarray(plane)
    out = {}
    for n in sizes:
        h, w = plane.shape
        hn, wn = h // n, w // n
        if hn == 0 or wn == 0:
            continue
        vals = _rank_grid_refs(plane, zscan, n, bd)
        fvals = _filter_grid_refs(vals, n, strong, bd) if n > 4 else None
        ob = plane[:hn * n, :wn * n].reshape(hn, n, wn, n) \
            .transpose(0, 2, 1, 3).reshape(-1, n, n)
        satds = _grid_mode_satds(ob, vals, fvals, n, bd)
        out[n] = satds.reshape(hn, wn, 35).astype(np.int32)
    return out


def _rank_static(w, h, n, zscan_np, device):
    """Per-geometry index tensors of the rank program for one size."""
    from turingcodec_tpu_torch.decode.reconstruct import _HVD_THRES
    from turingcodec_tpu_torch.encode.sweep import _stacked_tables
    key = (w, h, n, zscan_np.tobytes(), str(device))
    st = _STATIC.get(key)
    if st is not None:
        return st
    hn, wn = h // n, w // n
    B = hn * wn
    m = 4 * n + 1
    tx = np.empty(m, np.int32)
    ty = np.empty(m, np.int32)
    tx[:2 * n + 1] = -1
    tx[2 * n + 1:] = np.arange(2 * n)
    ty[:2 * n] = 2 * n - 1 - np.arange(2 * n)
    ty[2 * n:] = -1
    bx = (np.arange(wn) * n)[None, :, None]
    by = (np.arange(hn) * n)[:, None, None]
    px = np.broadcast_to(bx + tx[None, None, :], (hn, wn, m)).reshape(B, m)
    py = np.broadcast_to(by + ty[None, None, :], (hn, wn, m)).reshape(B, m)
    inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    pxc = np.clip(px, 0, w - 1)
    pyc = np.clip(py, 0, h - 1)
    zcur = zscan_np[by[:, :, 0] >> 2, bx[:, :, 0] >> 2].reshape(B, 1)
    ok = inb & (zscan_np[pyc >> 2, pxc >> 2] <= zcur)
    pos0, fact, neg = _stacked_tables(n)
    use_f = np.zeros(35, bool)
    if n > 4:
        thres = _HVD_THRES[n]
        for mode in range(35):
            if mode == 1:
                continue
            if mode != 0 and min(abs(mode - 26), abs(mode - 10)) <= thres:
                continue
            use_f[mode] = True

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    st = dict(pyc=t(pyc, torch.int64), pxc=t(pxc, torch.int64),
              ok=t(ok), pos0=t(pos0, torch.int64), fact=t(fact, torch.int32),
              negc=t(np.maximum(neg, 0), torch.int64), neg_is_c=t(neg < 0),
              use_f=use_f, use_f_ang=t(use_f[2:]))
    _STATIC[key] = st
    return st


def _rank_table(p32, st, w, h, n, bd, strong):
    """int32 plane -> (hn, wn, 35) int32 rank-SATD table for one size: the
    torch twin of rank_satd_tables_host (identical integers), with the 33
    angular modes batched."""
    hn, wn = h // n, w // n
    B = hn * wn
    m = 4 * n + 1
    dev = p32.device
    mid = 1 << (bd - 1)
    x = torch.arange(n, device=dev, dtype=torch.int32)
    log2n = int(n).bit_length() - 1
    block = 8 if n >= 8 else 4
    use_f = st["use_f"]

    # reference samples with z-scan availability substitution
    vals = p32[st["pyc"], st["pxc"]]  # (B, m)
    ok = st["ok"]
    any_ok = ok.any(1)
    first = ok.to(torch.int32).argmax(1)
    barange = torch.arange(B, device=dev)
    vals[:, 0] = torch.where(ok[:, 0], vals[:, 0], vals[barange, first])
    ok = ok.clone()
    ok[:, 0] = True
    vals = torch.where(ok, vals, 0)
    src = torch.where(ok, torch.arange(m, device=dev)[None, :], 0)
    src = torch.cummax(src, 1).values
    vals = vals.gather(1, src)
    vals = torch.where(any_ok[:, None], vals, mid)

    rl = vals[:, :2 * n].flip(1)
    co = vals[:, 2 * n]
    rt = vals[:, 2 * n + 1:]
    if n > 4:
        ft0 = (co + 2 * rt[:, 0] + rt[:, 1] + 2) >> 2
        fl0 = (co + 2 * rl[:, 0] + rl[:, 1] + 2) >> 2
        ftm = (rt[:, :2 * n - 2] + 2 * rt[:, 1:2 * n - 1]
               + rt[:, 2:] + 2) >> 2
        flm = (rl[:, :2 * n - 2] + 2 * rl[:, 1:2 * n - 1]
               + rl[:, 2:] + 2) >> 2
        frt = torch.cat([ft0[:, None], ftm, rt[:, 2 * n - 1:]], 1)
        frl = torch.cat([fl0[:, None], flm, rl[:, 2 * n - 1:]], 1)
        fco = (rl[:, 0] + 2 * co + rt[:, 0] + 2) >> 2
        if strong and n == 32:
            t1 = (co + rt[:, 2 * n - 1] - 2 * rt[:, n - 1]).abs()
            t2 = (co + rl[:, 2 * n - 1] - 2 * rl[:, n - 1]).abs()
            is_str = (t1 < (1 << (bd - 5))) & (t2 < (1 << (bd - 5)))
            i = torch.arange(63, device=dev, dtype=torch.int32)
            s_t = ((63 - i)[None, :] * co[:, None]
                   + (i + 1)[None, :] * rt[:, 63][:, None] + 32) >> 6
            s_l = ((63 - i)[None, :] * co[:, None]
                   + (i + 1)[None, :] * rl[:, 63][:, None] + 32) >> 6
            frt = torch.where(is_str[:, None],
                              torch.cat([s_t, rt[:, 63:]], 1), frt)
            frl = torch.where(is_str[:, None],
                              torch.cat([s_l, rl[:, 63:]], 1), frl)
            fco = torch.where(is_str, co, fco)
    else:
        frt, frl, fco = rt, rl, co

    ob = p32[:hn * n, :wn * n].reshape(hn, n, wn, n).permute(
        0, 2, 1, 3).reshape(B, 1, n, n)

    def satd(preds):  # (B, M, n, n) -> (B, M)
        mm = preds.shape[1]
        bh = n // block
        d = (ob - preds).reshape(B, mm, bh, block, bh, block).permute(
            0, 1, 2, 4, 3, 5)
        # H d H summed in absolute value; the transpose between the two
        # passes does not change the sum
        t = _wht_last(_wht_last(d).transpose(-1, -2))
        s = t.abs().sum((-2, -1), dtype=torch.int32)
        s = (s + 2) >> 2 if block == 8 else (s + 1) >> 1
        return s.sum((2, 3), dtype=torch.int32)

    def planar(rt_, rl_):
        return (((n - 1 - x)[None, None, :] * rl_[:, :n, None]
                 + (x + 1)[None, None, :] * rt_[:, n][:, None, None]
                 + (n - 1 - x)[None, :, None] * rt_[:, None, :n]
                 + (x + 1)[None, :, None] * rl_[:, n][:, None, None]
                 + n) >> (log2n + 1))

    p0 = planar(frt, frl) if use_f[0] else planar(rt, rl)
    s0 = satd(p0[:, None])
    rtd, rld = (frt, frl) if use_f[1] else (rt, rl)
    dc = ((rtd[:, :n].sum(1, dtype=torch.int32)
           + rld[:, :n].sum(1, dtype=torch.int32) + n) >> (log2n + 1))
    s1 = satd(dc[:, None, None, None].expand(B, 1, n, n))

    # the 33 angular modes at once: rows 0..15 = modes 2..17 (main ref =
    # LEFT, negative extension from TOP), rows 16.. = modes 18..34
    negc, neg_is_c = st["negc"], st["neg_is_c"]

    def build_ext(rt_, rl_, co_):
        ext = torch.empty((B, 33, 3 * n + 2), dtype=torch.int32, device=dev)
        ext[:, :16, :n] = torch.where(neg_is_c[None, :16],
                                      co_[:, None, None], rt_[:, negc[:16]])
        ext[:, 16:, :n] = torch.where(neg_is_c[None, 16:],
                                      co_[:, None, None], rl_[:, negc[16:]])
        ext[:, :, n] = co_[:, None]
        ext[:, :16, n + 1:3 * n + 1] = rl_[:, None, :2 * n]
        ext[:, 16:, n + 1:3 * n + 1] = rt_[:, None, :2 * n]
        ext[:, :16, 3 * n + 1] = rl_[:, 2 * n - 1][:, None]
        ext[:, 16:, 3 * n + 1] = rt_[:, 2 * n - 1][:, None]
        return ext.reshape(B, -1)

    pos0, fact = st["pos0"], st["fact"]

    def angular(ext):
        return ((32 - fact) * ext[:, pos0] + fact * ext[:, pos0 + 1]
                + 16) >> 5

    pang = angular(build_ext(rt, rl, co))
    if n > 4:
        pfa = angular(build_ext(frt, frl, fco))
        pang = torch.where(st["use_f_ang"][None, :, None, None], pfa, pang)
    sang = satd(pang)
    out = torch.cat([s0, s1, sang], 1)
    return out.reshape(hn, wn, 35).to(torch.int32)


def rank_satd_tables_device(plane, zscan, bd, strong, device,
                            sizes=(4, 8, 16, 32)):
    """Device twin of rank_satd_tables_host: {n: (hn, wn, 35) int32}."""
    plane = np.asarray(plane, np.int16)
    zscan = np.asarray(zscan)
    h, w = plane.shape
    p32 = upload(plane, device)
    out = {}
    for n in sizes:
        if h // n == 0 or w // n == 0:
            continue
        st = _rank_static(w, h, n, zscan, p32.device)
        out[n] = _np32(_rank_table(p32, st, w, h, n, bd, bool(strong)))
    return out


def install_subpel_fields(enc) -> Optional[dict]:
    """Compute the subpel planes of each list's ref-0 plane on enc.device
    for native install; {(list, 0): (15, ph, pw) int16} or None."""
    if enc.sh.is_i or os.environ.get("TC_NO_SUBPEL_PLANES"):
        return None
    out = {}
    done = {}
    for lx in (0, 1):
        refs = enc.ref_lists[lx] if lx < len(enc.ref_lists) else []
        if not refs:
            continue
        plane = refs[0].planes[0]
        k = id(plane)
        if k not in done:
            done[k] = subpel_planes_device(np.asarray(plane),
                                           enc.sps.bit_depth_y, enc.device)
        out[(lx, 0)] = done[k]
    return out or None


def install_seed_fields(enc, orig) -> Optional[dict]:
    """Run the encoder analysis (lowres pre-ME + dense full-pel ME field
    and its SAD surface) on enc.device for the encoder's list-0/1 ref-0
    planes and prefill the Python caches; returns {list: (seed_mv,
    dense_mv|None, wb, hb, surf|None)} for the native install, or None when
    the stage does not apply. The surface comes with the dense field unless
    TC_NO_ME_SURF is set, as on the host prepass; lists that share a plane
    share its surface."""
    global surfaces
    if enc.sh.is_i or getattr(enc, "search_range", 0) < 16:
        return None
    want_dense = not os.environ.get("TC_NO_DENSEME")
    want_surf = want_dense and not os.environ.get("TC_NO_ME_SURF")
    fields = {}
    done = {}
    for lx in (0, 1):
        refs = enc.ref_lists[lx] if lx < len(enc.ref_lists) else []
        if not refs:
            continue
        plane = refs[0].planes[0]
        k = id(plane)
        if k not in done:
            surf = None
            if want_dense:
                sm, dm, ds, wb, hb, *rest = analysis_device(
                    np.asarray(orig[0]), np.asarray(plane), enc.device,
                    want_surf)
                if want_surf:
                    surf = rest[0]
                    surfaces += 1
            else:
                sm, wb, hb = seed_field_device(
                    np.asarray(orig[0]), np.asarray(plane), enc.device)
                dm = ds = None
            done[k] = (sm, dm, ds, wb, hb, surf)
        sm, dm, ds, wb, hb, surf = done[k]
        enc._lr_seed_cache[k] = (sm, wb, hb)
        if dm is not None:
            enc._dense_cache[k] = (dm, ds, wb, hb, surf)
        fields[lx] = (sm, dm, wb, hb, surf)
    return fields or None
