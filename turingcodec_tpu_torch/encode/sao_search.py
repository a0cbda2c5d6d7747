"""SAO parameter estimation (EncSao::rdSao analogue, turing/EncSao.h:32,950).

Per CTB: gather edge-class and band statistics from the deblocked picture vs
the source, derive RD-optimal offsets per class/band, pick the best of
{off, band, 4 edge classes} by distortion + lambda*rate. Chroma obeys the
shared-type constraint (sao_type_idx_chroma / eo_class_chroma cover both Cb
and Cr; offsets and band positions are per-component).

Closed form: offset k applied to n samples with error sum e changes SSD by
n*k^2 - 2*k*e.
"""
from __future__ import annotations

import numpy as np

from turingcodec_tpu_torch.decode.plan import PicturePlan
from turingcodec_tpu_torch.utils.profiler import TRACE

_EO_NEIGHBOURS = {
    0: ((0, -1), (0, 1)),
    1: ((-1, 0), (1, 0)),
    2: ((-1, -1), (1, 1)),
    3: ((-1, 1), (1, -1)),
}


def _best_offset(n, e, lam, max_off=7, sign=None):
    """Minimize n*k^2 - 2*k*e + lam*bits(k) over k (0 always allowed)."""
    if n == 0:
        return 0, 0.0
    best_k, best_c = 0, 0.0
    k0 = int(np.clip(round(e / n), -max_off, max_off))
    ks = range(0, k0 + 1) if k0 >= 0 else range(k0, 1)
    for k in ks:
        if sign is not None and k * sign < 0:
            continue
        c = n * k * k - 2.0 * k * e + lam * (abs(k) + 1)
        if c < best_c:
            best_c, best_k = c, k
    return best_k, best_c


def _ctb_candidates(o, r, y0, y1, x0, x1, bd, lam):
    """Per-candidate (cost, class, offsets) for one CTB of one component,
    plus the raw per-class statistics so merge candidates (applying a
    NEIGHBOUR's parameters to this CTB) can be distortion-costed.

    Returns {"off": ..., "band": ..., ("eo", 0..3): ...,
             ("eostats", 0..3): (cnt[5], esum[5]), "bandstats": (n, e)}."""
    h, w = r.shape
    ob = o[y0:y1, x0:x1]
    rb = r[y0:y1, x0:x1]
    err = (ob - rb).astype(np.float64)
    out = {"off": (0.0, 0, [0, 0, 0, 0])}

    for eo in range(4):
        (ady, adx), (bdy, bdx) = _EO_NEIGHBOURS[eo]
        ys = np.arange(y0, y1)
        xs = np.arange(x0, x1)
        Y, X = np.meshgrid(ys, xs, indexing="ij")
        ay, ax = Y + ady, X + adx
        by_, bx_ = Y + bdy, X + bdx
        valid = (ay >= 0) & (ay < h) & (ax >= 0) & (ax < w) & \
                (by_ >= 0) & (by_ < h) & (bx_ >= 0) & (bx_ < w)
        av = r[np.clip(ay, 0, h - 1), np.clip(ax, 0, w - 1)]
        bv = r[np.clip(by_, 0, h - 1), np.clip(bx_, 0, w - 1)]
        cat = 2 + np.sign(rb - av) + np.sign(rb - bv)
        remap = np.array([1, 2, 0, 3, 4])
        cat = np.where(valid, remap[cat], 0)
        cost = 0.0
        offs = []
        cnt = [0] * 5
        esum = [0.0] * 5
        for cls, sgn in ((1, 1), (2, 1), (3, -1), (4, -1)):
            m = cat == cls
            cnt[cls] = int(m.sum())
            esum[cls] = float(err[m].sum())
            k, c = _best_offset(cnt[cls], esum[cls], lam, sign=sgn)
            offs.append(k)
            cost += c
        out[("eo", eo)] = (cost, eo, offs)
        out[("eostats", eo)] = (cnt, esum)

    shift = bd - 5
    bands = (rb >> shift).ravel()
    n_b = np.bincount(bands, minlength=32)
    e_b = np.bincount(bands, weights=err.ravel(), minlength=32)
    kb = np.zeros(32, np.int32)
    cb = np.zeros(32)
    for b in range(32):
        kb[b], cb[b] = _best_offset(int(n_b[b]), float(e_b[b]), lam)
    best_pos, best_cost = 0, 1e30
    for pos in range(29):
        c = cb[pos:pos + 4].sum()
        if c < best_cost:
            best_cost, best_pos = c, pos
    out["band"] = (best_cost, best_pos, list(kb[best_pos:best_pos + 4]))
    out["bandstats"] = (n_b, e_b)
    return out


def _explicit_bits(key, cand, bd, c_idx):
    """Approximate signalling bits of one component's explicit params,
    mirroring write_sao's bins (type ctx bin + bypass, TR offsets, signs,
    band position / eo class)."""
    if key == "off":
        return 1 if c_idx <= 1 else 0
    _, cls, offs = cand[:3]
    # offset TR bits are NOT counted here: _best_offset already folds
    # lam*(|k|+1) per offset into the candidate cost (counting them again
    # biased decisions toward merge/off)
    bits = 2 if c_idx <= 1 else 0  # type ctx bin + band/edge bypass
    if key == "band":
        bits += sum(1 for k in offs if k) + 5  # signs + band position
    elif c_idx <= 1:
        bits += 2  # eo class (luma; chroma shared on cb)
    return bits


def _merge_delta_ssd(cands, t, cls, offs):
    """Delta-SSD of applying given (type, class, offsets) to a CTB whose
    per-class stats are in cands: sum n*k^2 - 2*k*e over affected
    classes/bands."""
    if t == 0:
        return 0.0
    d = 0.0
    if t == 1:
        n_b, e_b = cands["bandstats"]
        for i in range(4):
            k = int(offs[i])
            b = (int(cls) + i) & 31
            d += float(n_b[b]) * k * k - 2.0 * k * float(e_b[b])
    else:
        cnt, esum = cands[("eostats", int(cls))]
        for i, c in enumerate((1, 2, 3, 4)):
            k = int(offs[i])
            d += cnt[c] * k * k - 2.0 * k * esum[c]
    return d


_KEYS = ["off", "band", ("eo", 0), ("eo", 1), ("eo", 2), ("eo", 3)]


def estimate_sao(plan: PicturePlan, geom, orig, deblocked, lam: float,
                 cy0: int = 0, cy1: int = None, device=None):
    """Fill plan.sao_* for CTB rows [cy0, cy1): luma independent, chroma
    joint-type, and per-CTB merge-left/up decisions against explicit
    re-signalling (the reference's rdSao merge RDO, EncSao.h:963+).
    Raster scan so a merge target's parameters are final when consulted —
    which also makes a row-banded call sequence (the overlap follower)
    equal the whole-picture walk exactly. With a `device` and the whole
    picture, each CTB's statistics are gathered there in one pass
    (_estimate_sao_device); every other call gathers them on the host.
    Either way the same decision runs over the same statistics."""
    sps = plan.sps
    if cy1 is None:
        cy1 = sps.pic_height_in_ctbs_y
    ctbs = (min(cy1, sps.pic_height_in_ctbs_y) - cy0) \
        * sps.pic_width_in_ctbs_y
    if (device is not None and cy0 == 0
            and cy1 >= sps.pic_height_in_ctbs_y
            and _estimate_sao_device(plan, geom, orig, deblocked, lam,
                                     device)):
        TRACE.count("enc.sao.device_ctbs", ctbs)
        return
    TRACE.count("enc.sao.host_ctbs", ctbs)
    if _estimate_sao_native(plan, geom, orig, deblocked, lam, cy0, cy1):
        return
    ctb = sps.ctb_size_y
    hc, wc = cy1, sps.pic_width_in_ctbs_y
    o32 = [p.astype(np.int32) for p in orig]
    r32 = [p.astype(np.int32) for p in deblocked]
    cs = ctb // 2
    for cy in range(cy0, hc):
        for cx in range(wc):
            h, w = r32[0].shape
            y0, x0 = cy * ctb, cx * ctb
            cl = _ctb_candidates(o32[0], r32[0], y0, min(y0 + ctb, h),
                                 x0, min(x0 + ctb, w), sps.bit_depth_y, lam)
            cands_c = []
            for ci in (1, 2):
                hh, ww = r32[ci].shape
                yy, xx = cy * cs, cx * cs
                cands_c.append(_ctb_candidates(
                    o32[ci], r32[ci], yy, min(yy + cs, hh),
                    xx, min(xx + cs, ww), sps.bit_depth_c, lam))

            left_ok = (cx > 0
                       and plan.slice_idx[cy, cx - 1] == plan.slice_idx[cy, cx]
                       and geom.tile_id[cy, cx] == geom.tile_id[cy, cx - 1])
            up_ok = (cy > 0
                     and plan.slice_idx[cy - 1, cx] == plan.slice_idx[cy, cx]
                     and geom.tile_id[cy, cx] == geom.tile_id[cy - 1, cx])

            # explicit (new) decision per component with signalling bits
            def kname(key):
                return key if isinstance(key, str) else "eo"

            lbest, lcost = None, 0.0
            for key in _KEYS:
                c = cl[key][0] + lam * _explicit_bits(
                    kname(key), cl[key], sps.bit_depth_y, 0)
                if lbest is None or c < lcost:
                    lbest, lcost = key, c
            cbest, ccost = None, 0.0
            for key in _KEYS:
                c = (cands_c[0][key][0] + cands_c[1][key][0]
                     + lam * (_explicit_bits(kname(key), cands_c[0][key],
                                             sps.bit_depth_c, 1)
                              + _explicit_bits(kname(key), cands_c[1][key],
                                               sps.bit_depth_c, 2)))
                if cbest is None or c < ccost:
                    cbest, ccost = key, c
            new_cost = lcost + ccost \
                + lam * ((1 if left_ok else 0) + (1 if up_ok else 0))

            # merge candidates: apply the neighbour's resolved params
            def merge_cost(ny, nx, flag_bits):
                d = 0.0
                for ci, cands in ((0, cl), (1, cands_c[0]), (2, cands_c[1])):
                    t = int(plan.sao_type[ny, nx, ci])
                    d += _merge_delta_ssd(cands, t,
                                          int(plan.sao_class[ny, nx, ci]),
                                          plan.sao_offsets[ny, nx, ci])
                return d + lam * flag_bits

            choice = 0
            best = new_cost
            if left_ok:
                c = merge_cost(cy, cx - 1, 1)
                if c < best:
                    best, choice = c, 1
            if up_ok:
                c = merge_cost(cy - 1, cx, 2 if left_ok else 1)
                if c < best:
                    best, choice = c, 2
            plan.sao_merge[cy, cx] = choice
            if choice == 1:
                plan.sao_type[cy, cx] = plan.sao_type[cy, cx - 1]
                plan.sao_class[cy, cx] = plan.sao_class[cy, cx - 1]
                plan.sao_offsets[cy, cx] = plan.sao_offsets[cy, cx - 1]
            elif choice == 2:
                plan.sao_type[cy, cx] = plan.sao_type[cy - 1, cx]
                plan.sao_class[cy, cx] = plan.sao_class[cy - 1, cx]
                plan.sao_offsets[cy, cx] = plan.sao_offsets[cy - 1, cx]
            else:
                _apply(plan, cy, cx, 0, lbest, cl[lbest])
                _apply(plan, cy, cx, 1, cbest, cands_c[0][cbest])
                _apply(plan, cy, cx, 2, cbest, cands_c[1][cbest])


def _estimate_sao_native(plan, geom, orig, deblocked, lam,
                         cy0=0, cy1=None) -> bool:
    """C twin of the loop above (enc_core.cpp tc_sao_estimate: the gather
    of each CTB's statistics, then the decision)."""
    lib = _native_for(plan)
    if lib is None:
        return False
    sps = plan.sps
    o = [np.ascontiguousarray(p, np.int16) for p in orig]
    r = deblocked
    for p in r:
        if p.dtype != np.int16 or not p.flags.c_contiguous:
            return False
    optrs = np.array([p.ctypes.data for p in o], np.int64)
    rptrs = np.array([p.ctypes.data for p in r], np.int64)
    tile_id = np.ascontiguousarray(geom.tile_id, np.int32)
    if cy1 is None:
        cy1 = sps.pic_height_in_ctbs_y
    lib.tc_sao_estimate(
        optrs.ctypes.data, rptrs.ctypes.data,
        plan.sao_type.ctypes.data, plan.sao_class.ctypes.data,
        plan.sao_offsets.ctypes.data, plan.sao_merge.ctypes.data,
        plan.slice_idx.ctypes.data, tile_id.ctypes.data,
        sps.pic_width_in_ctbs_y, sps.pic_height_in_ctbs_y, sps.ctb_size_y,
        sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples,
        sps.bit_depth_y, sps.bit_depth_c, float(lam), cy0, cy1)
    return True


def _native_for(plan):
    """The native core where it can estimate this picture's SAO (4:2:0,
    TURING_TPU_NO_NATIVE_ENC unset), else None."""
    import os
    if os.environ.get("TURING_TPU_NO_NATIVE_ENC"):
        return None
    from turingcodec_tpu_torch import native
    lib = native.get_lib()
    if lib is None or plan.sps.chroma_array_type != 1:
        return None
    return lib


def _estimate_sao_device(plan, geom, orig, deblocked, lam, device) -> bool:
    """The whole picture's statistics on `device` (ops/sao_stats.py: one
    kernel launch on a card; the plain version on the CPU) from one
    packed upload of the deblocked and source planes, brought down by one
    pinned copy; then the native raster-order decision (tc_sao_decide)."""
    lib = _native_for(plan)
    if lib is None:
        return False
    import torch

    from turingcodec_tpu_torch.ops import kernel_build
    from turingcodec_tpu_torch.ops.sao_stats import sao_stats
    sps = plan.sps
    device = torch.device(device)
    planes = kernel_build.upload_packed(
        [np.ascontiguousarray(p, np.int16) for p in (*deblocked, *orig)],
        device, span="enc.sao.upload")
    stats = sao_stats(planes[3:], planes[:3], sps.ctb_size_y,
                      sps.bit_depth_y, sps.bit_depth_c)
    if device.type == "cuda":
        host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
        host.copy_(stats, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        stats = host
    stats = stats.numpy()
    tile_id = np.ascontiguousarray(geom.tile_id, np.int32)
    lib.tc_sao_decide(
        stats.ctypes.data, plan.sao_type.ctypes.data,
        plan.sao_class.ctypes.data, plan.sao_offsets.ctypes.data,
        plan.sao_merge.ctypes.data, plan.slice_idx.ctypes.data,
        tile_id.ctypes.data, sps.pic_width_in_ctbs_y, sps.bit_depth_y,
        sps.bit_depth_c, float(lam), 0, sps.pic_height_in_ctbs_y)
    return True


def _apply(plan, cy, cx, c_idx, key, cand):
    _, cls, offs = cand
    if key == "off":
        plan.sao_type[cy, cx, c_idx] = 0
        plan.sao_class[cy, cx, c_idx] = 0
        plan.sao_offsets[cy, cx, c_idx] = 0
    elif key == "band":
        plan.sao_type[cy, cx, c_idx] = 1
        plan.sao_class[cy, cx, c_idx] = cls
        plan.sao_offsets[cy, cx, c_idx] = offs
    else:
        plan.sao_type[cy, cx, c_idx] = 2
        plan.sao_class[cy, cx, c_idx] = cls
        plan.sao_offsets[cy, cx, c_idx] = offs
