"""Native (C++) CABAC decode core loader.

Compiles cabac_core.cpp on first use (g++ -O2 -shared) into a cached .so and
exposes `residual_decode(dec, log2_size, c_idx, scan_idx, sdh)` which runs
the residual_coding hot loop natively, advancing the Python CabacDecoder's
state exactly as the pure-Python path would (parity: tests/test_native.py).

Set TURING_TPU_NO_NATIVE=1 to force the pure-Python path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False


_TLS = None  # created lazily (threading import kept off the hot path)


def _tls():
    global _TLS
    if _TLS is None:
        import threading
        _TLS = threading.local()
    return _TLS


def enc_threads() -> int:
    """WPP row threads for the native picture encode (TaskEncodeSubstream
    analogue). Default = CPU count; output is bit-identical at any count
    (reference signature.cpp's threads-1 row asserts the same invariant).
    Override with TURING_TPU_ENC_THREADS (1 = sequential walk), or per
    thread via set_thread_enc_threads (frame-parallel encoding divides
    the budget between in-flight pictures)."""
    ov = getattr(_tls(), "enc_threads", None)
    if ov:
        return ov
    nthr = os.environ.get("TURING_TPU_ENC_THREADS")
    if nthr:
        return max(1, int(nthr))
    return os.cpu_count() or 1


def set_thread_enc_threads(n) -> None:
    """Per-thread WPP thread budget (None clears the override)."""
    _tls().enc_threads = n


def bind_thread_ctx() -> None:
    """Bind this thread's native picture context (allocated on first
    use): every later native call from this thread (slice setup, encode,
    write) operates on that context, so pictures can encode concurrently
    (tc_ctx_new/bind in enc_core.cpp)."""
    lib = get_lib()
    if lib is None:
        return
    t = _tls()
    if getattr(t, "ctx", None) is None:
        t.ctx = lib.tc_ctx_new()
    lib.tc_ctx_bind(t.ctx)


def _build_and_load():
    here = os.path.dirname(__file__)
    srcs = [os.path.join(here, f)
            for f in ("cabac_core.cpp", "slice_parse.cpp",
                      "pixel_recon.cpp", "enc_core.cpp", "write_core.cpp")]
    newest = max(os.path.getmtime(s) for s in
                 srcs + [os.path.join(here, "core.h")])
    prof = bool(os.environ.get("TURING_TPU_NATIVE_PROF"))
    so = os.path.join(here, f"_cabac_core_{sys.implementation.cache_tag}"
                            f"{'_prof' if prof else ''}.so")
    if not os.path.exists(so) or os.path.getmtime(so) < newest:
        # compiled at runtime on the host machine (the analogue of the
        # reference's xbyak JIT), so -march=native is safe
        # per-process temporary: concurrent first uses (test workers)
        # each build and atomically install their own copy
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-o", tmp] + srcs
        if os.environ.get("TURING_TPU_NATIVE_PROF"):
            cmd.insert(1, "-DTC_ENC_PROF")
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.tc_init_tables.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tc_residual_decode.restype = ctypes.c_int
    lib.tc_residual_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]

    from turingcodec_tpu_torch.cabac.engine import ctx_index
    from turingcodec_tpu_torch.cabac.tables import (
        NEXT_STATE_LPS, NEXT_STATE_MPS, RANGE_TAB_LPS)
    from turingcodec_tpu_torch.hevc.tables import SIG_CTX_4x4
    from turingcodec_tpu_torch.decode.ctu_parse import _scan

    rt = np.ascontiguousarray(RANGE_TAB_LPS, np.uint8)
    nm = np.ascontiguousarray(NEXT_STATE_MPS, np.uint8)
    nl = np.ascontiguousarray(NEXT_STATE_LPS, np.uint8)
    s4 = np.ascontiguousarray(SIG_CTX_4x4, np.uint8)
    offs = np.array([ctx_index("sig_coeff_flag"),
                     ctx_index("coded_sub_block_flag"),
                     ctx_index("last_sig_coeff_x_prefix"),
                     ctx_index("last_sig_coeff_y_prefix"),
                     ctx_index("coeff_abs_level_greater1_flag"),
                     ctx_index("coeff_abs_level_greater2_flag")], np.int32)
    scans = []
    for s in range(4):
        for idx in range(3):
            t = np.asarray(_scan(s, idx), np.int8)[:, :2]
            scans.append(np.ascontiguousarray(t).reshape(-1))
    sc = np.concatenate(scans).astype(np.int8)
    lib.tc_init_tables(rt.ctypes.data, nm.ctypes.data, nl.ctypes.data,
                       s4.ctypes.data, offs.ctypes.data, sc.ctypes.data)

    from turingcodec_tpu_torch.cabac.rate import BITS
    lib.tc_init_rate.argtypes = [ctypes.c_void_p]
    lib.tc_residual_bits.restype = ctypes.c_int64
    lib.tc_residual_bits.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    bits = np.ascontiguousarray(BITS, np.int32)
    lib.tc_init_rate(bits.ctypes.data)

    from turingcodec_tpu_torch.hevc.tables import dct2_matrix, DST4
    lib.tc_init_intra.argtypes = [ctypes.c_void_p] * 8
    lib.tc_intra_tu.restype = ctypes.c_int
    lib.tc_intra_tu.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    from turingcodec_tpu_torch.hevc.tables import LEVEL_SCALE
    from turingcodec_tpu_torch.decode.reconstruct import (intra_inv_angle,
                                                    intra_pred_angle)
    mats = [np.ascontiguousarray(dct2_matrix(1 << k), np.int32)
            for k in (2, 3, 4, 5)]
    dst = np.ascontiguousarray(DST4, np.int32)
    ls = np.ascontiguousarray(LEVEL_SCALE, np.int32)
    ang = np.zeros(35, np.int8)
    inv = np.zeros(35, np.int16)
    for mode in range(2, 35):
        ang[mode] = intra_pred_angle(mode)
        if 11 <= mode <= 25:
            inv[mode] = intra_inv_angle(mode)
    _keep = (mats, dst, ls, ang, inv)
    lib._tc_keep = _keep  # prevent GC before init copies... (copied in C)
    lib.tc_init_intra(mats[0].ctypes.data, mats[1].ctypes.data,
                      mats[2].ctypes.data, mats[3].ctypes.data,
                      dst.ctypes.data, ls.ctypes.data, ang.ctypes.data,
                      inv.ctypes.data)

    lib.tc_inter_recon.restype = ctypes.c_int
    lib.tc_inter_recon.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32]

    lib.tc_deblock.restype = ctypes.c_int
    lib.tc_deblock.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]

    lib.tc_intra_recon.restype = ctypes.c_int
    lib.tc_intra_recon.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32]

    lib.tc_sao_estimate.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32]

    lib.tc_enc_setup.argtypes = [ctypes.c_void_p] * 5
    lib.tc_enc_set_frac_out.restype = None
    lib.tc_enc_set_frac_out.argtypes = [ctypes.c_void_p]
    lib.tc_enc_install_seeds.restype = None
    lib.tc_enc_install_seeds.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.tc_enc_install_dense.restype = None
    lib.tc_enc_install_dense.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.tc_enc_install_subpel.restype = None
    lib.tc_enc_install_subpel.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32]
    lib.tc_enc_subpel_plane.restype = None
    lib.tc_enc_subpel_plane.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p]
    lib.tc_enc_install_ranksatd.restype = None
    lib.tc_enc_install_ranksatd.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.tc_enc_install_aqlayer.restype = None
    lib.tc_enc_install_aqlayer.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32]
    lib.tc_enc_overlap_setup.restype = None
    lib.tc_enc_overlap_setup.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.tc_dense_analysis.restype = None
    lib.tc_dense_analysis.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tc_enc_install_densesurf.restype = None
    lib.tc_enc_install_densesurf.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.tc_ctx_new.restype = ctypes.c_void_p
    lib.tc_ctx_new.argtypes = []
    lib.tc_ctx_bind.restype = None
    lib.tc_ctx_bind.argtypes = [ctypes.c_void_p]
    lib.tc_ctx_free.restype = None
    lib.tc_ctx_free.argtypes = [ctypes.c_void_p]
    lib.tc_enc_ctu.restype = ctypes.c_double
    lib.tc_enc_picture.restype = ctypes.c_double
    lib.tc_enc_picture.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32]
    lib.tc_enc_ctu.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double]

    lib.tc_sao_apply.restype = ctypes.c_int
    lib.tc_sao_apply.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32]

    lib.tc_write_ctu.restype = ctypes.c_int
    lib.tc_write_ctu.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    lib.tc_write_terminate.restype = ctypes.c_int
    lib.tc_write_terminate.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32]

    lib.tc_slice_setup.argtypes = [ctypes.c_void_p] * 5
    lib.tc_parse_ctu.restype = ctypes.c_int
    lib.tc_parse_ctu.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.tc_parse_slice.restype = ctypes.c_int
    lib.tc_parse_slice.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    return lib


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TURING_TPU_NO_NATIVE"):
        return None
    try:
        _LIB = _build_and_load()
    except Exception as e:
        # fall back to the pure-Python path, but never silently: a broken
        # native build otherwise shows up only as a huge slowdown
        import traceback
        msg = str(e)
        if isinstance(e, subprocess.CalledProcessError) and e.stderr:
            msg = e.stderr.decode(errors="replace")[-2000:]
        print("turingcodec_tpu_torch: native core unavailable, pure-Python "
              "fallback in use:\n" + msg, file=sys.stderr)
        traceback.print_exc(limit=2, file=sys.stderr)
        _LIB = None
    return _LIB


_NUMCTX = None


def residual_decode(dec, log2_size: int, c_idx: int, scan_idx: int,
                    sdh: bool):
    """Run residual_coding natively from the last-position syntax down.

    Returns the (n, n) int16 coefficient block, or None when the native
    library is unavailable (caller falls back to Python). Advances `dec`
    (pos/range/offset/contexts) exactly like the Python path."""
    lib = get_lib()
    if lib is None:
        return None
    states = dec.ctx.states
    if type(states) is not bytearray:  # legacy list pools: fall back
        return None
    n = 1 << log2_size
    ctx = (ctypes.c_uint8 * len(states)).from_buffer(states)  # zero-copy
    pos = ctypes.c_int64(dec.pos)
    rng = ctypes.c_int32(dec.range)
    off = ctypes.c_int32(dec.offset)
    out = np.zeros((n, n), np.int16)
    rc = lib.tc_residual_decode(
        dec.data, 8 * len(dec.data), ctypes.byref(pos), ctypes.byref(rng),
        ctypes.byref(off), ctx, log2_size, c_idx, scan_idx, int(sdh),
        out.ctypes.data)
    if rc != 0:
        raise ValueError("native residual_coding failed (corrupt stream?)")
    dec.pos = pos.value
    dec.range = rng.value
    dec.offset = off.value
    dec._cache = 0
    dec._cache_bits = 0
    return out


def residual_bits(ctx_pool, log2_size: int, c_idx: int, scan_idx: int,
                  sdh: bool, levels: np.ndarray):
    """Fractional bits (float) of residual_coding, mutating ctx_pool exactly
    like the writer; None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or type(ctx_pool.states) is not bytearray:
        return None
    blk = np.ascontiguousarray(levels, np.int16)
    ctx = (ctypes.c_uint8 * len(ctx_pool.states)).from_buffer(ctx_pool.states)
    frac = lib.tc_residual_bits(ctx, log2_size, c_idx, scan_idx, int(sdh),
                                blk.ctypes.data)
    if frac < 0:
        raise ValueError("residual_bits on an all-zero block")
    return frac / 256.0


# ---- native inter reconstruction (pixel_recon.cpp) -------------------------

_RECON_TABLES = None   # (lf, cf, mats, ls)
_CQT_CACHE = {}        # (qp_bd_c, chroma_format_idc) -> table


def _recon_tables():
    global _RECON_TABLES
    if _RECON_TABLES is None:
        from turingcodec_tpu_torch.hevc.tables import (CHROMA_FILTER, LEVEL_SCALE,
                                                 LUMA_FILTER, dct2_matrix)
        lf = np.ascontiguousarray(LUMA_FILTER, np.int32)
        cf = np.ascontiguousarray(CHROMA_FILTER, np.int32)
        mats = np.concatenate([
            np.ascontiguousarray(dct2_matrix(1 << k), np.int32).reshape(-1)
            for k in (2, 3, 4, 5)])
        ls = np.ascontiguousarray(LEVEL_SCALE, np.int32)
        _RECON_TABLES = (lf, cf, mats, ls)
    return _RECON_TABLES


def _cqt_table(sps):
    key = (sps.qp_bd_offset_c, sps.chroma_format_idc)
    t = _CQT_CACHE.get(key)
    if t is None:
        from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
        t = np.array([chroma_qp_from_luma(q, sps.chroma_format_idc)
                      for q in range(-sps.qp_bd_offset_c, 58)], np.int32)
        _CQT_CACHE[key] = t
    return t


def _slice_qp_offsets(plan):
    pps = plan.pps
    n_sl = max(len(plan.slice_headers), 1)
    cb_off = np.zeros(n_sl, np.int32)
    cr_off = np.zeros(n_sl, np.int32)
    for i, sh in enumerate(plan.slice_headers):
        cb_off[i] = pps.pps_cb_qp_offset + sh.slice_cb_qp_offset
        cr_off[i] = pps.pps_cr_qp_offset + sh.slice_cr_qp_offset
    return cb_off, cr_off


def _recon_iparams(plan, geom):
    sps = plan.sps
    return np.array([
        sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples,
        geom.w4, geom.h4, geom.wc, geom.hc, sps.ctb_log2_size_y,
        sps.bit_depth_y, sps.bit_depth_c, sps.qp_bd_offset_y,
        sps.qp_bd_offset_c], np.int32)


def _cu_tu_records(cus):
    """Flatten CuInfo list into the (n, 8) cu / (m, 9) tu record arrays."""
    n_cu = len(cus)
    cu_arr = np.zeros((n_cu, 8), np.int32)
    tus = []
    for i, cu in enumerate(cus):
        cu_arr[i, 0] = cu.x0
        cu_arr[i, 1] = cu.y0
        cu_arr[i, 2] = cu.log2_size
        cu_arr[i, 3] = cu.part_mode
        cu_arr[i, 4] = int(cu.skip)
        cu_arr[i, 5] = int(cu.tq_bypass)
        cu_arr[i, 6] = len(cu.tus)
        tus.extend(cu.tus)
    tu_arr = (np.array(tus, np.int32).reshape(-1, 9) if tus
              else np.zeros((1, 9), np.int32))
    return cu_arr, tu_arr


def _recon_records(plan, pred_mode):
    """(cu_arr, tu_arr) in the recon layout (x0, y0, log2, part, skip,
    tqb, ntus, 0) for CUs of the given pred_mode, straight from the native
    parser's record arrays when available (no CuInfo materialization).
    Native parse never emits PCM CUs (try_create gates pcm streams)."""
    raw = (plan.cu_list.record_arrays()
           if hasattr(plan.cu_list, "record_arrays") else None)
    if raw is None:
        cus = [cu for cu in plan.cu_list
               if cu.pred_mode == pred_mode and not cu.pcm]
        if not cus:
            return None, None
        return _cu_tu_records(cus)
    cu, tu = raw
    sel = np.nonzero(cu[:, 3] == pred_mode)[0]
    if not len(sel):
        return None, None
    ntus_all = cu[:, 7]
    starts_all = np.zeros(len(cu), np.int64)
    np.cumsum(ntus_all[:-1], out=starts_all[1:])
    lengths = ntus_all[sel].astype(np.int64)
    starts = starts_all[sel]
    total = int(lengths.sum())
    if total:
        ends = np.cumsum(lengths)
        idx = (np.arange(total, dtype=np.int64)
               + np.repeat(starts - np.concatenate(([0], ends[:-1])),
                           lengths))
        tu_sel = np.ascontiguousarray(tu[idx])
    else:
        tu_sel = np.zeros((1, 9), np.int32)
    out = np.empty((len(sel), 8), np.int32)
    out[:, 0:3] = cu[sel, 0:3]
    out[:, 3] = cu[sel, 4]
    out[:, 4] = cu[sel, 5]
    out[:, 5] = cu[sel, 6]
    out[:, 6] = ntus_all[sel]
    out[:, 7] = 0
    return out, tu_sel


def inter_recon(plan, geom, ref_lists, recon) -> bool:
    """MC + residual add for all inter CUs natively. False -> caller falls
    back to the numpy path (lib unavailable / unsupported stream shape)."""
    if os.environ.get("TURING_TPU_NO_NATIVE_RECON"):
        return False
    lib = get_lib()
    if lib is None:
        return False
    sps, pps = plan.sps, plan.pps
    if sps.chroma_array_type != 1 or sps.scaling_list_enabled_flag:
        return False

    cu_arr, tu_arr = _recon_records(plan, 0)
    if cu_arr is None:
        return True
    n_cu = len(cu_arr)

    ry, rcb, rcr = recon
    ref_ptrs = np.zeros(2 * 16 * 3, np.int64)
    keep = []
    for l in (0, 1):
        for r, pic in enumerate(ref_lists[l][:16]):
            for c in (0, 1, 2):
                pl = pic.planes[c]
                if pl.dtype != np.int16 or not pl.flags.c_contiguous:
                    return False
                ref_ptrs[(l * 16 + r) * 3 + c] = pl.ctypes.data
                keep.append(pl)

    p = plan
    arrays = [ry, rcb, rcr, p.coeff_y, p.coeff_cb, p.coeff_cr,
              p.transform_skip_y, p.transform_skip_cb, p.transform_skip_cr,
              p.qp_y, p.mv, p.ref_idx, p.slice_idx]
    for a in arrays:
        if not a.flags.c_contiguous:
            return False
    ptrs = np.concatenate([np.array([a.ctypes.data for a in arrays],
                                    np.int64), ref_ptrs])

    iparams = _recon_iparams(plan, geom)
    lf, cf, mats, ls = _recon_tables()
    cqt = _cqt_table(sps)
    cb_off, cr_off = _slice_qp_offsets(plan)

    rval = lib.tc_inter_recon(
        ptrs.ctypes.data, iparams.ctypes.data, lf.ctypes.data, cf.ctypes.data,
        mats.ctypes.data, ls.ctypes.data, cqt.ctypes.data, len(cqt),
        cb_off.ctypes.data, cr_off.ctypes.data, cu_arr.ctypes.data, n_cu,
        tu_arr.ctypes.data, len(cb_off))
    if rval != 0:
        raise ValueError(f"native inter recon failed (rc={rval})")
    return True


def sao_apply(plan, geom, deblocked, cy0=0, cy1=None, out=None):
    """Native SAO application; returns new planes or None (fallback).
    cy0/cy1 restrict to CTB rows [cy0, cy1) (the overlap follower's
    banded publisher); `out` supplies persistent destination planes
    whose band must already hold the deblocked samples."""
    if os.environ.get("TURING_TPU_NO_NATIVE_RECON"):
        return None
    lib = get_lib()
    sps, pps = plan.sps, plan.pps
    if lib is None or sps.chroma_array_type != 1:
        return None
    for p in deblocked:
        if p.dtype != np.int16 or not p.flags.c_contiguous:
            return None
    if cy1 is None:
        cy1 = sps.pic_height_in_ctbs_y
    if out is None:
        out = [p.copy() for p in deblocked]
    skip = None
    if sps.pcm_enabled_flag and sps.pcm_loop_filter_disabled_flag:
        skip = plan.pcm_flag
    if pps.transquant_bypass_enabled_flag:
        skip = plan.tq_bypass if skip is None else (plan.tq_bypass
                                                    | plan.pcm_flag)
    if skip is not None:
        skip = np.ascontiguousarray(skip, np.uint8)
    n_sl = max(len(plan.slice_headers), 1)
    sl_l = np.zeros(n_sl, np.int32)
    sl_c = np.zeros(n_sl, np.int32)
    sl_a = np.zeros(n_sl, np.int32)
    for i, sh in enumerate(plan.slice_headers):
        sl_l[i] = int(sh.slice_sao_luma_flag)
        sl_c[i] = int(sh.slice_sao_chroma_flag)
        sl_a[i] = int(sh.slice_loop_filter_across_slices_enabled_flag)
    tile_id = np.ascontiguousarray(geom.tile_id, np.int32)
    src_ptrs = np.array([p.ctypes.data for p in deblocked], np.int64)
    dst_ptrs = np.array([p.ctypes.data for p in out], np.int64)
    lib.tc_sao_apply(
        src_ptrs.ctypes.data, dst_ptrs.ctypes.data,
        plan.sao_type.ctypes.data, plan.sao_class.ctypes.data,
        plan.sao_offsets.ctypes.data, plan.slice_idx.ctypes.data,
        tile_id.ctypes.data,
        sps.pic_width_in_ctbs_y, sps.pic_height_in_ctbs_y, sps.ctb_size_y,
        sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples,
        sps.bit_depth_y, sps.bit_depth_c,
        sl_l.ctypes.data, sl_c.ctypes.data, sl_a.ctypes.data, n_sl,
        int(pps.loop_filter_across_tiles_enabled_flag),
        skip.ctypes.data if skip is not None else 0, geom.w4, cy0, cy1)
    return out


def dense_analysis(orig_y, ref_y, bd, nthreads=1):
    """Standalone encoder pre-analysis (lowres seeds + dense full-pel ME
    field + winner SADs) via tc_dense_analysis; None when native is
    unavailable. Values are integer-exact with the Python twins
    (inter_search._lowres_seed_field / _dense_field)."""
    if os.environ.get("TURING_TPU_NO_NATIVE") \
            or os.environ.get("TURING_TPU_NO_NATIVE_ENC"):
        return None
    lib = get_lib()
    if lib is None:
        return None
    h, w = orig_y.shape
    lw, lh = -(-w // 4), -(-h // 4)
    wb, hb = -(-lw // 4), -(-lh // 4)
    o = np.ascontiguousarray(orig_y, np.int16)
    r = np.ascontiguousarray(ref_y, np.int16)
    sm = np.zeros((hb, wb, 2), np.int16)
    dm = np.zeros((hb, wb, 2), np.int16)
    ds = np.zeros((hb, wb), np.int32)
    surf = None
    surf_ptr = None
    if not os.environ.get("TC_NO_ME_SURF"):
        # full 17x17 SAD surface per block: the full-pel search serves
        # aligned probes from it (exact integers)
        surf = np.zeros((hb * wb, 17 * 17), np.int32)
        surf_ptr = ctypes.c_void_p(surf.ctypes.data)
    lib.tc_dense_analysis(o.ctypes.data, r.ctypes.data, w, h, bd,
                          nthreads, sm.ctypes.data, dm.ctypes.data,
                          ds.ctypes.data, surf_ptr)
    return (sm.astype(np.int32), dm.astype(np.int32), ds, wb, hb, surf)


def intra_recon(pr) -> bool:
    """Reconstruct all intra CUs of a PictureReconstructor natively, in
    decode order, falling back per-CU (stop-and-resume) for transquant
    bypass / transform-skip TUs. False -> caller runs the Python loop."""
    if os.environ.get("TURING_TPU_NO_NATIVE_RECON"):
        return False
    lib = get_lib()
    if lib is None:
        return False
    plan, geom = pr.plan, pr.geom
    sps = plan.sps
    if (sps.chroma_array_type != 1 or pr.scaling is not None
            or plan.pcm_samples or pr.refs._complex_bounds()):
        return False
    cu_arr, tu_arr = _recon_records(plan, 1)
    if cu_arr is None:
        return True
    tu_starts = np.zeros(len(cu_arr) + 1, np.int64)
    np.cumsum(cu_arr[:, 6], out=tu_starts[1:])

    p = plan
    ry, rcb, rcr = pr.ry, pr.rcb, pr.rcr
    arrays = [ry, rcb, rcr, p.coeff_y, p.coeff_cb, p.coeff_cr,
              p.transform_skip_y, p.transform_skip_cb, p.transform_skip_cr,
              p.qp_y, p.mv, p.ref_idx, p.slice_idx,
              p.intra_mode_y, p.intra_mode_c]
    for a in arrays:
        if not a.flags.c_contiguous:
            return False
    ptrs = np.array([a.ctypes.data for a in arrays], np.int64)
    iparams = _recon_iparams(plan, geom)
    _, _, mats, ls = _recon_tables()
    cqt = _cqt_table(sps)
    cb_off, cr_off = _slice_qp_offsets(plan)
    zscan32 = np.ascontiguousarray(geom.zscan, np.int32)
    strong = int(sps.strong_intra_smoothing_enabled_flag != 0)

    def cu_at(k):
        # minimal CuInfo for the Python oracle (modes/QP come from the
        # plan tensors, not the record)
        from turingcodec_tpu_torch.decode.ctu_parse import CuInfo
        cu = CuInfo()
        row = cu_arr[k]
        cu.x0, cu.y0, cu.log2_size = int(row[0]), int(row[1]), int(row[2])
        cu.pred_mode = 1
        cu.part_mode = int(row[3])
        cu.skip = bool(row[4])
        cu.tq_bypass = bool(row[5])
        s = int(tu_starts[k])
        cu.tus = [tuple(t)
                  for t in tu_arr[s:s + int(row[6])].tolist()]
        return cu

    n_cu = len(cu_arr)
    idx = 0
    while idx < n_cu:
        nxt = lib.tc_intra_recon(
            ptrs.ctypes.data, iparams.ctypes.data, mats.ctypes.data,
            ls.ctypes.data, cqt.ctypes.data, len(cqt), cb_off.ctypes.data,
            cr_off.ctypes.data, zscan32.ctypes.data, strong,
            cu_arr.ctypes.data, n_cu, tu_arr.ctypes.data, idx,
            int(tu_starts[idx]), len(cb_off))
        if nxt >= n_cu:
            break
        pr._recon_intra_cu(cu_at(nxt))  # unsupported CU: Python oracle
        idx = nxt + 1
    return True


class DeblockNative:
    """Reusable (banded) native deblock driver for one picture's planes.

    `run_band(vy0, vy1, ey0, ey1)` filters vertical-edge segments with
    luma y in [vy0, vy1) and horizontal edges at luma y in [ey0, ey1) —
    a lagged band sequence is sample-exact with the whole-picture pass
    (the inter-picture overlap follower publishes loop-filtered rows
    this way while the CTU search below still runs)."""

    @staticmethod
    def try_create(plan, geom, ry, rcb, rcr):
        if os.environ.get("TURING_TPU_NO_NATIVE_RECON"):
            return None
        lib = get_lib()
        if lib is None:
            return None
        if plan.sps.chroma_array_type != 1:
            return None
        p = plan
        arrays = [ry, rcb, rcr, p.tu_id, p.pu_id, p.cu_id, p.cu_pred_mode,
                  p.cbf_y, p.ref_idx, p.ref_poc, p.mv, p.qp_y, p.slice_idx]
        for a in arrays:
            if not a.flags.c_contiguous:
                return None
        return DeblockNative(lib, plan, geom, arrays)

    def __init__(self, lib, plan, geom, arrays):
        self.lib = lib
        sps, pps = plan.sps, plan.pps
        tile_id = np.ascontiguousarray(geom.tile_id, np.int32)
        ptrs = np.array(
            [a.ctypes.data for a in arrays] + [tile_id.ctypes.data],
            np.int64)
        iparams = _recon_iparams(plan, geom)
        from turingcodec_tpu_torch.decode.deblock import BETA_TABLE, TC_TABLE
        beta = np.ascontiguousarray(BETA_TABLE, np.int32)
        tc = np.ascontiguousarray(TC_TABLE, np.int32)
        cqt = _cqt_table(sps)
        cb_off, cr_off = _slice_qp_offsets(plan)
        n_sl = len(cb_off)
        sl_dis = np.zeros(n_sl, np.int32)
        sl_beta = np.zeros(n_sl, np.int32)
        sl_tc = np.zeros(n_sl, np.int32)
        sl_across = np.zeros(n_sl, np.int32)
        for i, sh in enumerate(plan.slice_headers):
            sl_dis[i] = int(sh.slice_deblocking_filter_disabled_flag)
            sl_beta[i] = sh.slice_beta_offset_div2
            sl_tc[i] = sh.slice_tc_offset_div2
            sl_across[i] = \
                int(sh.slice_loop_filter_across_slices_enabled_flag)
        self._keep = (arrays, tile_id, ptrs, iparams, beta, tc, cqt,
                      cb_off, cr_off, sl_dis, sl_beta, sl_tc, sl_across)
        self._args = (ptrs.ctypes.data, iparams.ctypes.data,
                      beta.ctypes.data, tc.ctypes.data, cqt.ctypes.data,
                      len(cqt), sl_dis.ctypes.data, sl_beta.ctypes.data,
                      sl_tc.ctypes.data, sl_across.ctypes.data,
                      cb_off.ctypes.data, cr_off.ctypes.data,
                      int(pps.loop_filter_across_tiles_enabled_flag),
                      len(cb_off))
        self.pic_h = plan.sps.pic_height_in_luma_samples

    def run_band(self, vy0, vy1, ey0, ey1):
        self.lib.tc_deblock(*self._args, vy0, vy1, ey0, ey1)

    def run(self):
        self.run_band(0, self.pic_h, 0, self.pic_h)


def deblock(plan, geom, ry, rcb, rcr) -> bool:
    """Native deblocking of the three planes in place. False -> caller runs
    the numpy path."""
    db = DeblockNative.try_create(plan, geom, ry, rcb, rcr)
    if db is None:
        return False
    db.run()
    return True


# ---- full-CTU native parse (slice_parse.cpp) ------------------------------

def _slice_setup(lib, plan, geom, sh, slice_number, hook=None):
    """Configure the shared native picture context (SP g_sp) for one slice.

    hook carries motion-derivation inputs (InterDeriver-like: cur_poc,
    ref_pocs, ref_lt, no_backward, col_pic) or None for paths that don't
    derive motion (I slices, the CABAC writer). Returns the keep-alive
    tuple the caller must hold while the context is in use."""
    sps, pps = plan.sps, plan.pps
    zscan = geom.zscan
    assert zscan.dtype == np.int64 and zscan.flags.c_contiguous
    tile_id = np.ascontiguousarray(geom.tile_id, np.int32)

    ref_pocs = np.zeros((2, 16), np.int32)
    ref_lt = np.zeros((2, 16), np.uint8)
    col = None
    no_backward = 0
    cur_poc = 0
    if hook is not None:
        cur_poc = hook.cur_poc
        no_backward = int(hook.no_backward)
        for l in (0, 1):
            for i, p_ in enumerate(hook.ref_pocs[l][:16]):
                ref_pocs[l, i] = p_
            for i, lt in enumerate(hook.ref_lt[l][:16]):
                ref_lt[l, i] = int(lt)
        col = hook.col_pic
        if col is not None and col.plan is None:
            col = None
    has_col = int(col is not None)
    cp = col.plan if col is not None else plan

    p = plan
    ptr_arrays = [
        zscan, tile_id, p.slice_idx, p.ct_depth, p.cu_pred_mode,
        p.part_mode, p.skip_flag, p.tq_bypass, p.pcm_flag, p.intra_mode_y,
        p.intra_mode_c, p.mv, p.ref_idx, p.merge_flag, p.merge_idx,
        p.mvd, p.mvp_flag, p.ref_poc, p.ref_is_lt, p.qp_y, p.cu_size_log2,
        p.pu_id, p.cu_id, p.tu_log2, p.tu_id, p.cbf_y, p.cbf_cb, p.cbf_cr,
        p.transform_skip_y, p.transform_skip_cb, p.transform_skip_cr,
        p.coeff_y, p.coeff_cb, p.coeff_cr, p.sao_type, p.sao_class,
        p.sao_offsets, p.sao_merge, cp.cu_pred_mode, cp.ref_idx, cp.mv,
        cp.ref_poc, cp.ref_is_lt,
    ]
    for a in ptr_arrays:
        assert a.flags.c_contiguous
    ptrs = np.array([a.ctypes.data for a in ptr_arrays], np.int64)
    iparams = np.array([
        sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples,
        geom.w4, geom.h4, geom.wc, geom.hc,
        sps.ctb_log2_size_y, sps.min_cb_log2_size_y,
        sps.max_tb_log2_size_y, sps.min_tb_log2_size_y,
        sps.max_transform_hierarchy_depth_intra,
        sps.max_transform_hierarchy_depth_inter,
        int(sps.amp_enabled_flag),
        sps.bit_depth_y, sps.bit_depth_c, sps.qp_bd_offset_y,
        int(pps.cu_qp_delta_enabled_flag), pps.diff_cu_qp_delta_depth,
        int(pps.transquant_bypass_enabled_flag),
        int(pps.transform_skip_enabled_flag),
        int(pps.sign_data_hiding_enabled_flag),
        pps.log2_parallel_merge_level_minus2 + 2,
        sh.slice_qp_y, slice_number, int(sh.is_i), int(sh.is_b),
        sh.max_num_merge_cand,
        sh.num_ref_idx_l0_active_minus1 + 1,
        sh.num_ref_idx_l1_active_minus1 + 1,
        int(sh.mvd_l1_zero_flag),
        int(sh.slice_temporal_mvp_enabled_flag),
        int(sh.collocated_from_l0_flag),
        int(sh.slice_sao_luma_flag), int(sh.slice_sao_chroma_flag),
        cur_poc, col.poc if col is not None else 0,
        no_backward, has_col,
    ], np.int32)
    from turingcodec_tpu_torch.cabac.engine import ctx_index
    offs = np.array([ctx_index(e) for e in _PARSE_ELEMS], np.int32)
    lib.tc_slice_setup(ptrs.ctypes.data, iparams.ctypes.data,
                       offs.ctypes.data, ref_pocs.ctypes.data,
                       ref_lt.ctypes.data)
    return (ptr_arrays, ptrs, iparams, offs, ref_pocs, ref_lt, col)


class WriterNative:
    """Per-slice native CABAC writer: bins for whole CTUs plus terminate/
    flush, into a growable byte buffer (encode/ctu_write.py oracle)."""

    @staticmethod
    def try_create(plan, geom, sh, slice_number):
        if os.environ.get("TURING_TPU_NO_NATIVE_WRITE"):
            return None
        lib = get_lib()
        if lib is None:
            return None
        sps = plan.sps
        if sps.chroma_array_type != 1 or plan.pcm_samples:
            return None
        try:
            return WriterNative(lib, plan, geom, sh, slice_number)
        except Exception:
            return None

    def __init__(self, lib, plan, geom, sh, slice_number):
        self.lib = lib
        self._keep = _slice_setup(lib, plan, geom, sh, slice_number)
        sps = plan.sps
        cap = (sps.pic_width_in_luma_samples
               * sps.pic_height_in_luma_samples * 4 + (1 << 16))
        self.buf = np.zeros(cap, np.uint8)
        self.cap_bits = cap * 8
        self.bitpos = np.zeros(1, np.int64)
        self.eng = np.zeros(4, np.int32)
        self.qp_io = np.zeros(4, np.int32)
        self.reset_engine()

    def reset_engine(self):
        """Fresh CabacEncoder state (low 0, range 510, first-bit discard)."""
        self.eng[:] = (0, 510, 0, 1)

    def write_ctu(self, ws, ctb_addr_rs: int):
        self.qp_io[:] = (ws.qp_y_pred, ws.last_cu_qp,
                         int(ws.is_cu_qp_delta_coded), ws.cu_qp_delta_val)
        states = ws.ctx.states
        ctx = (ctypes.c_uint8 * len(states)).from_buffer(states)
        rc = self.lib.tc_write_ctu(
            self.buf.ctypes.data, self.cap_bits, self.bitpos.ctypes.data,
            self.eng.ctypes.data, ctx, ctb_addr_rs, self.qp_io.ctypes.data)
        if rc != 0:
            raise ValueError(f"native CTU write failed (rc={rc})")
        ws.qp_y_pred = int(self.qp_io[0])
        ws.last_cu_qp = int(self.qp_io[1])
        ws.is_cu_qp_delta_coded = bool(self.qp_io[2])
        ws.cu_qp_delta_val = int(self.qp_io[3])

    def encode_terminate(self, bit: int):
        rc = self.lib.tc_write_terminate(
            self.buf.ctypes.data, self.cap_bits, self.bitpos.ctypes.data,
            self.eng.ctypes.data, bit)
        if rc != 0:
            raise ValueError("native terminate failed")

    def take_substream(self) -> bytes:
        """Byte-align (zero padding) and return+reset the buffered bytes."""
        nbytes = (int(self.bitpos[0]) + 7) >> 3
        out = self.buf[:nbytes].tobytes()
        self.buf[:nbytes] = 0
        self.bitpos[0] = 0
        self.reset_engine()
        return out


# must match the E_* enum order in slice_parse.cpp
_PARSE_ELEMS = [
    "sao_merge_flag", "sao_type_idx", "split_cu_flag",
    "cu_transquant_bypass_flag", "cu_skip_flag", "pred_mode_flag",
    "part_mode", "prev_intra_luma_pred_flag", "intra_chroma_pred_mode",
    "rqt_root_cbf", "merge_flag", "merge_idx", "inter_pred_idc", "ref_idx",
    "mvp_flag", "abs_mvd_greater0_flag", "abs_mvd_greater1_flag",
    "split_transform_flag", "cbf_luma", "cbf_chroma", "cu_qp_delta_abs",
    "transform_skip_flag_luma", "transform_skip_flag_chroma",
]


class SliceNative:
    """Per-slice driver for the native full-CTU parser.

    Owns the record buffers and the io state arrays; `parse_ctu` advances the
    Python CabacDecoder's state exactly like decode/ctu_parse.parse_ctu.
    """

    @staticmethod
    def try_create(plan, geom, sh, slice_number, hook):
        if os.environ.get("TURING_TPU_NO_NATIVE_PARSE"):
            return None
        lib = get_lib()
        if lib is None:
            return None
        from turingcodec_tpu_torch.cabac.engine import TRACE
        if TRACE is not None:
            return None
        sps = plan.sps
        if getattr(sps, "pcm_enabled_flag", 0):
            return None
        if sps.chroma_array_type != 1:
            return None
        if hook is not None:
            from turingcodec_tpu_torch.decode.mvp import InterDeriver
            if not isinstance(hook, InterDeriver):
                return None
        try:
            return SliceNative(lib, plan, geom, sh, slice_number, hook)
        except Exception:
            return None

    def __init__(self, lib, plan, geom, sh, slice_number, hook):
        self.lib = lib
        self.plan = plan
        sps = plan.sps
        # keep everything the C globals point at alive for this object's life
        self._keep = _slice_setup(lib, plan, geom, sh, slice_number, hook)

        w = sps.pic_width_in_luma_samples
        h = sps.pic_height_in_luma_samples
        max_cu = ((w + 7) // 8) * ((h + 7) // 8) + 64
        max_tu = geom.w4 * geom.h4 + 64
        self.cu_rec = np.zeros(max_cu * 8, np.int32)
        self.tu_rec = np.zeros(max_tu * 9, np.int32)
        self.counts = np.zeros(2, np.int32)
        self.qp_io = np.zeros(4, np.int32)
        if not hasattr(plan, "id_counters"):
            plan.id_counters = [0, 0, 0]
        self.ids = np.array(plan.id_counters, np.int32)
        self._fn = lib.tc_parse_ctu
        self._qp_ptr = self.qp_io.ctypes.data
        self._ids_ptr = self.ids.ctypes.data
        self._cu_ptr = self.cu_rec.ctypes.data
        self._tu_ptr = self.tu_rec.ctypes.data
        self._counts_ptr = self.counts.ctypes.data

    def parse_slice(self, ps, geom, sh, start_ts: int) -> int:
        """Drive the whole slice_segment_data loop natively (WPP/tile
        substream handling included). Returns the ts after the last CTU;
        advances ps.dec / ps QP-chain / ps.ctx exactly like the Python
        loop."""
        dec = ps.dec
        sps = self.plan.sps
        self.qp_io[0] = ps.qp_y_pred
        self.qp_io[1] = ps.last_cu_qp
        self.qp_io[2] = int(ps.is_cu_qp_delta_coded)
        self.qp_io[3] = ps.cu_qp_delta_val
        states = dec.ctx.states
        ctx = (ctypes.c_uint8 * len(states)).from_buffer(states)
        pos = ctypes.c_int64(dec.pos)
        rng = ctypes.c_int32(dec.range)
        off = ctypes.c_int32(dec.offset)
        end_ts = ctypes.c_int32(0)
        from turingcodec_tpu_torch.cabac.engine import ContextPool
        init = ContextPool()
        init.initialize(sh.init_type(), sh.slice_qp_y)
        init_states = bytes(init.states)
        tsc = np.ascontiguousarray(geom.tile_scan_ctus, np.int32)
        wpp = int(bool(self.plan.pps.entropy_coding_sync_enabled_flag))
        rc = self.lib.tc_parse_slice(
            dec.data, 8 * len(dec.data), ctypes.byref(pos),
            ctypes.byref(rng), ctypes.byref(off), ctx, start_ts, wpp,
            len(states), init_states, tsc.ctypes.data, self._qp_ptr,
            self._ids_ptr, self._cu_ptr, self._tu_ptr, self._counts_ptr,
            ctypes.byref(end_ts))
        if rc != 0:
            raise ValueError(f"native slice parse failed (rc={rc}; "
                             "corrupt stream?)")
        dec.pos = pos.value
        dec.range = rng.value
        dec.offset = off.value
        dec._cache = 0
        dec._cache_bits = 0
        ps.qp_y_pred = int(self.qp_io[0])
        ps.last_cu_qp = int(self.qp_io[1])
        ps.is_cu_qp_delta_coded = bool(self.qp_io[2])
        ps.cu_qp_delta_val = int(self.qp_io[3])
        return int(end_ts.value)

    def parse_ctu(self, ps, ctb_addr_rs: int):
        """Parse one CTU natively, advancing ps.dec and ps QP-chain state."""
        dec = ps.dec
        self.qp_io[0] = ps.qp_y_pred
        self.qp_io[1] = ps.last_cu_qp
        self.qp_io[2] = int(ps.is_cu_qp_delta_coded)
        self.qp_io[3] = ps.cu_qp_delta_val
        states = dec.ctx.states
        ctx = (ctypes.c_uint8 * len(states)).from_buffer(states)
        pos = ctypes.c_int64(dec.pos)
        rng = ctypes.c_int32(dec.range)
        off = ctypes.c_int32(dec.offset)
        rc = self._fn(dec.data, 8 * len(dec.data), ctypes.byref(pos),
                      ctypes.byref(rng), ctypes.byref(off), ctx,
                      ctb_addr_rs, self._qp_ptr, self._ids_ptr,
                      self._cu_ptr, self._tu_ptr, self._counts_ptr)
        if rc != 0:
            raise ValueError(f"native CTU parse failed (rc={rc}; "
                             "corrupt stream?)")
        dec.pos = pos.value
        dec.range = rng.value
        dec.offset = off.value
        dec._cache = 0
        dec._cache_bits = 0
        ps.qp_y_pred = int(self.qp_io[0])
        ps.last_cu_qp = int(self.qp_io[1])
        ps.is_cu_qp_delta_coded = bool(self.qp_io[2])
        ps.cu_qp_delta_val = int(self.qp_io[3])

    def finish(self):
        """Hand the raw CU/TU record arrays to the plan (materialized into
        CuInfo lazily; the native recon paths read them directly)."""
        plan = self.plan
        n_cu, n_tu = int(self.counts[0]), int(self.counts[1])
        plan.id_counters[:] = [int(v) for v in self.ids]
        cu_arr = self.cu_rec[:n_cu * 8].reshape(n_cu, 8).copy()
        tu_arr = self.tu_rec[:n_tu * 9].reshape(n_tu, 9).copy()
        if hasattr(plan.cu_list, "parts"):
            plan.cu_list.parts.append((cu_arr, tu_arr))
        else:  # plain list (defensive)
            from turingcodec_tpu_torch.decode.plan import CuRecordList
            holder = CuRecordList()
            holder.parts.append((cu_arr, tu_arr))
            plan.cu_list.extend(holder)


# ---- native encoder search core (enc_core.cpp) -----------------------------

class EncNative:
    """Per-picture driver for the native CTU RDO search. encode_ctu is the
    drop-in replacement for IntraPictureEncoder._decide_cqt at CTU roots."""

    @staticmethod
    def try_create(enc, plan):
        if os.environ.get("TURING_TPU_NO_NATIVE_ENC"):
            return None
        lib = get_lib()
        if lib is None:
            return None
        sps, pps = enc.sps, enc.pps
        if (getattr(enc, "wp", None) is not None
                or getattr(enc, "slice_row_map", None) is not None
                or sps.chroma_array_type != 1
                or sps.scaling_list_enabled_flag
                or pps.constrained_intra_pred_flag
                or pps.transform_skip_enabled_flag
                or enc.geom.num_tiles > 1):
            return None
        try:
            return EncNative(lib, enc, plan)
        except Exception:
            return None

    def __init__(self, lib, enc, plan):
        self.lib = lib
        self._frac = None
        sps = enc.sps
        geom = enc.geom
        sh = enc.sh
        ref_lists = getattr(enc, "ref_lists", None) or [[], []]
        deriver = None if sh.is_i else enc._get_deriver()
        keep_sp = _slice_setup(lib, plan, geom, sh, 0, deriver)

        # encoder-side setup
        self._orig = [np.ascontiguousarray(pl, np.int16) for pl in enc.orig]
        rec = enc.recon
        for r in rec:
            assert r.dtype == np.int16 and r.flags.c_contiguous
        zscan32 = np.ascontiguousarray(geom.zscan, np.int32)
        ref_ptrs = np.zeros(2 * 16 * 3, np.int64)
        keep_refs = []
        for l in (0, 1):
            for r, pic in enumerate(ref_lists[l][:16]):
                for c in (0, 1, 2):
                    pl = pic.planes[c]
                    assert pl.dtype == np.int16 and pl.flags.c_contiguous
                    ref_ptrs[(l * 16 + r) * 3 + c] = pl.ctypes.data
                    keep_refs.append(pl)
        eptrs = np.concatenate([
            np.array([a.ctypes.data for a in self._orig]
                     + [a.ctypes.data for a in rec]
                     + [zscan32.ctypes.data], np.int64),
            ref_ptrs])
        from turingcodec_tpu_torch.cabac.tables import NUM_CONTEXTS
        eip = np.array([enc.rd_candidates,
                        enc.max_cu_log2,
                        getattr(enc, "max_cu_inter_log2", enc.max_cu_log2),
                        getattr(enc, "search_range", 0),
                        int(sps.strong_intra_smoothing_enabled_flag != 0),
                        NUM_CONTEXTS,
                        int(getattr(enc, "rcudepth", False)),
                        int(getattr(enc, "use_rdoq", False)),
                        int(getattr(enc, "met", False)),
                        int(getattr(enc, "fdam", False)),
                        int(getattr(enc, "rqt", False)),
                        int(getattr(enc, "esd", False)),
                        int(getattr(enc, "aps", False)),
                        int(getattr(enc, "_overlap", False))], np.int32)
        from turingcodec_tpu_torch.hevc.tables import QUANT_SCALES
        qs = np.ascontiguousarray(QUANT_SCALES, np.int32)
        lf, cf, _, _ = _recon_tables()
        lib.tc_enc_setup(eptrs.ctypes.data, eip.ctypes.data, qs.ctypes.data,
                         lf.ctypes.data, cf.ctypes.data)
        self._keep = (keep_sp, self._orig, rec, zscan32, keep_refs, eptrs,
                      eip, qs, lf, cf, deriver)
        self.ids = np.zeros(3, np.int32)
        self.sps = sps

    def setup_overlap(self, enc):
        """Bind the inter-picture overlap plumbing (call after __init__,
        which passed the overlap flag to tc_enc_setup via eip[13]): this
        picture's search-row counter, plus each reference picture's
        follower-published final-row counter and u8 luma shadow. A ref
        without an `ovl_rows` slot predates overlap mode and is complete
        (native converts its u8 shadow eagerly)."""
        ref_lists = getattr(enc, "ref_lists", None) or [[], []]
        rows = np.zeros(32, np.int64)
        u8s = np.zeros(32, np.int64)
        keep = []
        for l in (0, 1):
            for r, pic in enumerate(ref_lists[l][:16]):
                slot = getattr(pic, "ovl_rows", None)
                if slot is not None:
                    rows[l * 16 + r] = slot.ctypes.data
                    keep.append(slot)
                p8 = getattr(pic, "ovl_u8", None)
                if p8 is not None:
                    u8s[l * 16 + r] = p8.ctypes.data
                    keep.append(p8)
        sr = enc._ovl_self_rows
        self._keep_ovl = (rows, u8s, keep, sr)
        self.lib.tc_enc_overlap_setup(int(sr.ctypes.data),
                                      rows.ctypes.data, u8s.ctypes.data)

    def encode_picture_all(self, enc) -> float:
        """Whole-picture CTU walk in one native call (WPP rate-context
        inheritance + per-CTB AQ QP/lambda included) — replaces the
        per-CTU Python loop when no per-row slice map is in use."""
        sps, pps = self.sps, enc.pps
        wc = sps.pic_width_in_ctbs_y
        hc = sps.pic_height_in_ctbs_y
        n = hc * wc
        qp3 = np.empty((n, 3), np.int32)
        lam3 = np.empty((n, 3), np.float64)
        lam_me0 = float(getattr(enc, "lam_me", 0.0))
        has_me = hasattr(enc, "lam_me")
        if enc.qp_map is None:
            qp3[:, 0] = enc.qp + sps.qp_bd_offset_y
            qp3[:, 1] = enc.qp_cb + sps.qp_bd_offset_c
            qp3[:, 2] = enc.qp_cr + sps.qp_bd_offset_c
            lam3[:, 0] = enc.lam
            lam3[:, 1] = enc.lam_bits
            lam3[:, 2] = lam_me0
        else:
            from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
            qs = np.asarray(enc.qp_map, np.int64).reshape(-1)
            lam0 = getattr(enc, "_lam0", enc.lam)
            lam = lam0 * 2.0 ** ((qs - enc._base_lam_qp) / 3.0)
            lam3[:, 0] = lam
            lam3[:, 1] = lam
            lam3[:, 2] = np.sqrt(lam) if has_me else 0.0
            qp3[:, 0] = qs + sps.qp_bd_offset_y
            lo = -sps.qp_bd_offset_c

            def cq(off):
                return np.array(
                    [chroma_qp_from_luma(int(max(lo, min(57, q + off))))
                     for q in qs], np.int32) + sps.qp_bd_offset_c

            qp3[:, 1] = cq(pps.pps_cb_qp_offset)
            qp3[:, 2] = cq(pps.pps_cr_qp_offset)
            # mirror the sequential loop's trailing _set_ctb_qp state
            enc._set_ctb_qp(int(qs[-1]))
        wpp = int(bool(pps.entropy_coding_sync_enabled_flag))
        snap_rx = 1 if wc > 1 else 0
        from turingcodec_tpu_torch.cabac.engine import ContextPool
        init = ContextPool()
        init.initialize(enc.sh.init_type(), enc.sh.slice_qp_y)
        init_states = bytes(init.states)
        self.ids[:] = enc.next_id
        states = enc.rd_ctx.states
        ctx = (ctypes.c_uint8 * len(states)).from_buffer(states)
        frac = np.zeros(n, np.int64)
        self.lib.tc_enc_set_frac_out(ctypes.c_void_p(frac.ctypes.data))
        try:
            cost = self.lib.tc_enc_picture(
                ctx, self.ids.ctypes.data, qp3.ctypes.data, lam3.ctypes.data,
                wpp, snap_rx, init_states, enc_threads())
        finally:
            self.lib.tc_enc_set_frac_out(None)
        if cost < 0:
            raise RuntimeError("native picture encode failed")
        enc.next_id[:] = [int(v) for v in self.ids]
        enc.ctu_frac_list = [int(v) for v in frac]
        return cost

    def reset_me_seeds(self):
        """Clear the row-local previous-integer-MV ME seed (tile-row
        starts; x0 == 0 resets implicitly inside tc_enc_ctu)."""
        self.lib.tc_enc_me_seed_reset()

    def install_seeds(self, fields):
        """Install device-computed encoder analysis fields
        (encode/device_analysis.py):
        {list: (seed_mv (hb, wb, 2), dense_mv|None, wb, hb[, surf|None])}.
        The native core copies each array, so none is kept here."""
        for lx, f in fields.items():
            sm, dm, wb, hb = f[:4]
            surf = f[4] if len(f) > 4 else None
            arr = np.ascontiguousarray(sm, np.int16).reshape(-1)
            self.lib.tc_enc_install_seeds(
                lx, ctypes.c_void_p(arr.ctypes.data), wb, hb)
            if dm is not None:
                darr = np.ascontiguousarray(dm, np.int16).reshape(-1)
                self.lib.tc_enc_install_dense(
                    lx, ctypes.c_void_p(darr.ctypes.data), wb, hb)
                if surf is not None:
                    sarr = np.ascontiguousarray(surf, np.int32)
                    self.lib.tc_enc_install_densesurf(
                        lx, ctypes.c_void_p(sarr.ctypes.data), wb, hb)

    def install_aq(self, layers):
        """Install the per-CU AQ pyramid: [(qp_y_full, qp_cb_full,
        qp_cr_full)] per layer d=0..D, each (hc<<d, wc<<d) int32 —
        decide_cqt queries layer min(depth, D) per CU trial."""
        self._keep_aq = []
        for d, (qy, qcb, qcr) in enumerate(layers):
            arrs = [np.ascontiguousarray(a, np.int32) for a in
                    (qy, qcb, qcr)]
            self._keep_aq += arrs
            hn, wn = arrs[0].shape
            self.lib.tc_enc_install_aqlayer(
                d, ctypes.c_void_p(arrs[0].ctypes.data),
                ctypes.c_void_p(arrs[1].ctypes.data),
                ctypes.c_void_p(arrs[2].ctypes.data), wn, hn)

    def install_subpel(self, fields):
        """Install device-computed subpel planes
        ({(list, ref): (15, ph, pw) int16}, encode/device_analysis.py
        subpel_planes_device — exact sp_build_plane values)."""
        self._keep_subpel = []
        for (lx, r), planes in fields.items():
            arr = np.ascontiguousarray(planes, np.int16)
            self._keep_subpel.append(arr)
            _, ph, pw = arr.shape
            self.lib.tc_enc_install_subpel(
                lx, r, ctypes.c_void_p(arr.ctypes.data), pw, ph)

    def install_ranksatd(self, tables):
        """Install device-computed source-referenced rank-SATD tables
        ({n: (hn, wn, 35) int32}, device_analysis.rank_satd_tables_device
        — the exact integers rank_modes' source-ref sweep produces)."""
        self._keep_rank = []
        for n, tab in tables.items():
            arr = np.ascontiguousarray(tab, np.int32)
            self._keep_rank.append(arr)
            hn, wn, _ = arr.shape
            self.lib.tc_enc_install_ranksatd(
                int(n).bit_length() - 1,
                ctypes.c_void_p(arr.ctypes.data), hn, wn)

    def subpel_plane(self, lx, r, xf, yf, pic_w, pic_h):
        """Read one (natively built) subpel plane — device-twin
        verification hook; (ph, pw) int16."""
        ph, pw = pic_h + 2 * 28, pic_w + 2 * 28
        out = np.zeros((ph, pw), np.int16)
        self.lib.tc_enc_subpel_plane(
            lx, r, xf, yf, ctypes.c_void_p(out.ctypes.data))
        return out

    def encode_ctu(self, enc, x0, y0) -> float:
        """Full RDO for the CTU at (x0, y0); advances enc.rd_ctx/next_id."""
        sps = self.sps
        self.ids[:] = enc.next_id
        states = enc.rd_ctx.states
        ctx = (ctypes.c_uint8 * len(states)).from_buffer(states)
        if self._frac is None:
            self._frac = np.zeros(
                sps.pic_width_in_ctbs_y * sps.pic_height_in_ctbs_y,
                np.int64)
        self.lib.tc_enc_set_frac_out(
            ctypes.c_void_p(self._frac.ctypes.data))
        try:
            cost = self.lib.tc_enc_ctu(
                x0, y0, ctx, self.ids.ctypes.data,
                enc.qp + sps.qp_bd_offset_y,
                enc.qp_cb + sps.qp_bd_offset_c,
                enc.qp_cr + sps.qp_bd_offset_c,
                float(enc.lam), float(enc.lam_bits),
                float(getattr(enc, "lam_me", 0.0)))
        finally:
            self.lib.tc_enc_set_frac_out(None)
        if cost < 0:
            raise RuntimeError("native CTU encode failed")
        enc.next_id[:] = [int(v) for v in self.ids]
        wc = sps.pic_width_in_ctbs_y
        ctb = sps.ctb_log2_size_y
        enc.ctu_frac_list.append(
            int(self._frac[(y0 >> ctb) * wc + (x0 >> ctb)]))
        return cost


def intra_tu(plane, zscan32, x0, y0, n, c_idx, sub, bit_depth, mode,
             strong, coeff_plane, cbf, qp, use_dst) -> bool:
    """Reconstruct one intra TB natively (build refs + filter + predict +
    dequant/IDCT + add + clip, in place). False if unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    lib.tc_intra_tu(plane.ctypes.data, plane.shape[1], plane.shape[0],
                    zscan32.ctypes.data, zscan32.shape[1], x0, y0, n,
                    c_idx, sub, bit_depth, mode, int(strong),
                    coeff_plane.ctypes.data, int(cbf), qp, int(use_dst))
    return True
