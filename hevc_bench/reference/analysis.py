"""Plain torch reference of the encoder's analysis stage.

Frozen copies, from commit dd78b9c, of the port's plain versions:
- edge_pad, dense_inputs, dense_me_argmin_ref: ops/dense_me.py;
- _first_min, _lowres_plane, block_dims, seed_field_ref, _subpel_planes,
  _rank_static, _rank_table: encode/device_analysis.py;
- _wht_last: ops/metrics.py; _angular_tables: ops/intra.py;
  _stacked_tables: encode/sweep.py; z_order_in_ctu and the z-scan table:
  hevc/geometry.py (one tile, one slice);
- LUMA_FILTER, INTRA_PRED_ANGLE, INTRA_INV_ANGLE: hevc/tables.py (HEVC
  Tables 8-11, 8-4, 8-5); _HVD_THRES: decode/reconstruct.py.

It imports nothing of the port, so a later change to the port's own plain
versions cannot move the yardstick. Every function is integer arithmetic
on the tensors' device; the results are exact on any device.
"""
from __future__ import annotations

import numpy as np
import torch

P = 48        # pad of the dense sweep's reference plane
SP_P = 28     # stored pad of the subpel planes
SP_EXT2 = 36  # edge pad so every clamped tap read is a plain slice
RANK_SIZES = (4, 8, 16, 32)

LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)
INTRA_PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], dtype=np.int32)
INTRA_INV_ANGLE = np.array([
    -4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482,
    -630, -910, -1638, -4096,
], dtype=np.int32)
HVD_THRES = {8: 7, 16: 1, 32: 0}


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicating pad of a 2-D tensor by clamped indexing."""
    h, w = x.shape
    ys = torch.arange(-top, h + bottom, device=x.device).clamp_(0, h - 1)
    xs = torch.arange(-left, w + right, device=x.device).clamp_(0, w - 1)
    return x[ys[:, None], xs[None, :]]


def _first_min(cost: torch.Tensor) -> torch.Tensor:
    """Index along dim 0 of the first minimum of non-negative integer
    costs: the min of the packed key (cost << 9) | k."""
    n = cost.shape[0]
    k = torch.arange(n, device=cost.device).reshape(
        (n,) + (1,) * (cost.dim() - 1))
    return ((cost.to(torch.int64) << 9) | k).min(0).values & 511


def _lowres_plane(src, f, b, wb, hb, border):
    """Edge-clamped decimation by rounded mean, padded to (hb*b, wb*b) +
    border."""
    h, w = src.shape
    lw, lh = -(-w // f), -(-h // f)
    p = edge_pad(src, 0, lh * f - h, 0, lw * f - w)
    lr = (p.reshape(lh, f, lw, f).sum((1, 3), dtype=torch.int32)
          + f * f // 2) // (f * f)
    return edge_pad(lr, border, hb * b - lh + border,
                    border, wb * b - lw + border)


def block_dims(w: int, h: int):
    """(wb, hb): the grid of 16x16 blocks the seed and dense fields cover."""
    lw, lh = -(-w // 4), -(-h // 4)
    return -(-lw // 4), -(-lh // 4)


def seed_field(orig: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(orig, ref) planes -> (hb, wb, 2) int32 lowres seed MVs: quarter-res
    exhaustive +/-8 with cost (SAD << 2) + |dx| + |dy| and scan-order
    ties, then a half-res +/-2 refinement."""
    orig, ref = orig.to(torch.int32), ref.to(torch.int32)
    h, w = orig.shape
    wb, hb = block_dims(w, h)
    dev = orig.device
    cur4 = _lowres_plane(orig, 4, 4, wb, hb, 0)
    ref4 = _lowres_plane(ref, 4, 4, wb, hb, 8)
    win = ref4.unfold(0, hb * 4, 1).unfold(1, wb * 4, 1)  # (17,17,H,W)
    sad = (cur4 - win).abs().reshape(17, 17, hb, 4, wb, 4).sum(
        (3, 5), dtype=torch.int32)
    a = torch.arange(-8, 9, device=dev, dtype=torch.int32).abs()
    cost = (sad << 2) + (a[:, None] + a[None, :])[:, :, None, None]
    k = _first_min(cost.reshape(289, hb, wb))
    sdy, sdx = k // 17 - 8, k % 17 - 8

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


def dense_field(orig: torch.Tensor, ref: torch.Tensor, seeds: torch.Tensor):
    """The dense full-pel +/-8 search around the seeds: ((hb, wb, 2) MVs,
    (hb, wb) winner SADs, (hb*wb, 289) SAD surface), int32; ties go to the
    first offset in (oy, ox) scan order."""
    orig, ref = orig.to(torch.int32), ref.to(torch.int32)
    h, w = orig.shape
    wb, hb = block_dims(w, h)
    dev = orig.device
    cur = edge_pad(orig, 0, hb * 16 - h, 0, wb * 16 - w)
    r = edge_pad(ref, P, hb * 16 - h + P, P, wb * 16 - w + P)
    cb = cur.reshape(hb, 16, wb, 16).permute(0, 2, 1, 3)
    by = torch.arange(hb, device=dev)[:, None]
    bx = torch.arange(wb, device=dev)[None, :]
    a32 = torch.arange(32, device=dev)
    ys = (by * 16 + seeds[:, :, 1] - 8 + P)[:, :, None, None] \
        + a32[None, None, :, None]
    xs = (bx * 16 + seeds[:, :, 0] - 8 + P)[:, :, None, None] \
        + a32[None, None, None, :]
    patches = r[ys, xs].reshape(hb * wb, 32, 32)
    c = cb.reshape(hb * wb, 16, 16)[:, None]
    win = patches.unfold(1, 16, 1).unfold(2, 16, 1)   # (B, 17, 17, 16, 16)
    b = hb * wb
    sad = torch.stack([(c - win[:, oy]).abs().sum((-2, -1))
                       for oy in range(17)], 1).reshape(b, 289)
    a = torch.arange(17, device=dev) - 8
    pen = (a[:, None].abs() + a[None, :].abs()).reshape(289)
    k = torch.arange(289, device=dev)
    key = (((sad << 2) + pen) << 9) | k
    kbest = key.min(1).values & 511
    off = torch.stack([kbest % 17 - 8, kbest // 17 - 8], 1).to(torch.int32)
    best = sad.gather(1, kbest[:, None])[:, 0].to(torch.int32)
    return (seeds + off.reshape(hb, wb, 2), best.reshape(hb, wb),
            sad.to(torch.int32))


def subpel_planes(ref: torch.Tensor, bd: int) -> torch.Tensor:
    """ref plane -> (15, h+2*SP_P, w+2*SP_P) int16: the 15 fractional luma
    positions of HEVC's 8-tap filter over the edge-replicated plane."""
    ref = ref.to(torch.int32)
    filt = LUMA_FILTER
    h, w = ref.shape
    shift1 = bd - 8
    pw, ph = w + 2 * SP_P, h + 2 * SP_P
    pwe, phe = w + 2 * (SP_P + 4), h + 2 * (SP_P + 4)
    ext2 = edge_pad(ref, SP_EXT2, SP_EXT2, SP_EXT2, SP_EXT2)
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


def z_order_in_ctu(n: int) -> np.ndarray:
    """(n, n) table: z (Morton) index of block (y, x) within a CTU grid."""
    idx = np.zeros((n, n), dtype=np.int64)
    for y in range(n):
        for x in range(n):
            z = 0
            for b in range(16):
                z |= ((x >> b) & 1) << (2 * b)
                z |= ((y >> b) & 1) << (2 * b + 1)
            idx[y, x] = z
    return idx


def zscan_table(w: int, h: int, ctb_log2: int) -> np.ndarray:
    """(h/4, w/4) z-scan address of every 4x4 block of a one-tile picture:
    the CTB's raster index shifted, plus the Morton index inside it."""
    n = 1 << (ctb_log2 - 2)
    w4, h4 = w // 4, h // 4
    wc = -(-w // (1 << ctb_log2))
    hc = -(-h // (1 << ctb_log2))
    zin = z_order_in_ctu(n)
    zscan = np.zeros((h4, w4), dtype=np.int64)
    for cy in range(hc):
        for cx in range(wc):
            base = (cy * wc + cx) << (2 * (ctb_log2 - 2))
            y0, x0 = cy * n, cx * n
            y1, x1 = min(y0 + n, h4), min(x0 + n, w4)
            zscan[y0:y1, x0:x1] = base + zin[: y1 - y0, : x1 - x0]
    return zscan


def _angular_tables(n: int):
    """Per angular mode 2..34: (is_vertical, gather positions (n, n),
    fractions (n, n), negative-extension sources (n + 1,))."""
    tabs = []
    for mode in range(2, 35):
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18
        d = np.arange(1, n + 1)
        i_idx = (d * angle) >> 5
        i_fact = (d * angle) & 31
        xs = np.arange(n)
        pos = n + 1 + (i_idx[:, None] if vertical else i_idx[None, :]) \
            + (xs[None, :] if vertical else xs[:, None])
        fact = (i_fact[:, None] if vertical else i_fact[None, :]) \
            * np.ones((n, n), np.int32)
        neg_src = np.zeros(n + 1, np.int32)
        if angle < 0:
            inv = int(INTRA_INV_ANGLE[mode - 11])
            for x in range(-1, ((n * angle) >> 5) - 1, -1):
                idx = ((x * inv + 128) >> 8) - 1
                neg_src[n + x] = min(max(idx, -1), 2 * n - 1)
        tabs.append((vertical, pos.astype(np.int32), fact.astype(np.int32),
                     neg_src))
    return tabs


def _stacked_tables(n):
    tabs = _angular_tables(n)
    pos = np.stack([t[1] for t in tabs]).astype(np.int64)   # (33, n, n)
    fact = np.stack([t[2] for t in tabs]).astype(np.int32)
    neg = np.stack([t[3][:n] for t in tabs])                # (33, n)
    base = (np.arange(33, dtype=np.int64) * (3 * n + 2))[:, None, None]
    return pos + base, fact, neg


def _wht_last(x: torch.Tensor) -> torch.Tensor:
    """Walsh-Hadamard transform along the last dim by butterflies."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    h = 1
    while h < n:
        y = x.reshape(lead + (n // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack((a + b, a - b), -2).reshape(lead + (n,))
        h *= 2
    return x


def _rank_static(w, h, n, zscan_np, device):
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
        thres = HVD_THRES[n]
        for mode in range(35):
            if mode == 1:
                continue
            if mode != 0 and min(abs(mode - 26), abs(mode - 10)) <= thres:
                continue
            use_f[mode] = True

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(pyc=t(pyc, torch.int64), pxc=t(pxc, torch.int64),
                ok=t(ok), pos0=t(pos0, torch.int64), fact=t(fact, torch.int32),
                negc=t(np.maximum(neg, 0), torch.int64), neg_is_c=t(neg < 0),
                use_f=use_f, use_f_ang=t(use_f[2:]))


def _rank_table(p32, st, w, h, n, bd, strong):
    """int32 plane -> (hn, wn, 35) int32 rank-SATD table for one size."""
    hn, wn = h // n, w // n
    B = hn * wn
    m = 4 * n + 1
    dev = p32.device
    mid = 1 << (bd - 1)
    x = torch.arange(n, device=dev, dtype=torch.int32)
    log2n = int(n).bit_length() - 1
    block = 8 if n >= 8 else 4
    use_f = st["use_f"]

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


def rank_tables(plane: torch.Tensor, ctb_log2: int, bd: int,
                strong: bool) -> dict:
    """{n: (h/n, w/n, 35) int32} source-referenced rank-SATD tables (35
    intra modes' Hadamard SATD of every aligned n x n block, n = 4..32)
    of a one-tile, one-slice picture."""
    h, w = plane.shape
    p32 = plane.to(torch.int32)
    zscan = zscan_table(w, h, ctb_log2)
    return {n: _rank_table(p32, _rank_static(w, h, n, zscan, p32.device),
                           w, h, n, bd, bool(strong))
            for n in RANK_SIZES if h // n and w // n}
