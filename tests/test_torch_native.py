"""The port's native (C++) core, turingcodec_tpu_torch.native, against its
pure-Python oracles: CABAC residual bits (and the JAX package's pure-Python
rate oracle), the AVX2 SATD, the folded forward transform, WPP row
threads, the native-vs-Python encoder searches, and the decode of
tests/streams against GOLDEN.json with and without the native core. The
twin of tests/test_native.py; it never imports the JAX package's native
module. The core builds on first use in each test process, into a
per-process temporary file, so concurrent workers cannot lose a build
race. Every value is an integer or a bit count: equality is exact."""
import hashlib
import json
import os
import pathlib

import numpy as np
import pytest

from turingcodec_tpu_torch import native

STREAMS = pathlib.Path(__file__).parent / "streams"
GOLDEN = json.loads((STREAMS / "GOLDEN.json").read_text())


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the port's native core did not build"
    return lib


def _random_block(rng, log2, density):
    n = 1 << log2
    blk = np.zeros((n, n), np.int32)
    m = rng.random((n, n)) < density
    blk[m] = rng.integers(-40, 40, m.sum())
    if not blk.any():
        blk[0, 0] = 3
    return blk


# the horizontal and vertical scans exist for 4x4 and 8x8 only
RESIDUAL_CASES = [(log2, scan, c_idx) for log2 in (2, 3, 4, 5)
                  for scan in ((0, 1, 2) if log2 <= 3 else (0,))
                  for c_idx in (0, 1)]


@pytest.mark.parametrize("log2,scan,c_idx", RESIDUAL_CASES)
def test_residual_bits_match_python(lib, log2, scan, c_idx):
    from turingcodec_tpu.cabac.engine import ContextPool as JContextPool
    from turingcodec_tpu.cabac.rate import RateEstimator as JRateEstimator
    from turingcodec_tpu.encode.ctu_write import (
        residual_core as j_residual_core)
    from turingcodec_tpu_torch.cabac.engine import ContextPool
    from turingcodec_tpu_torch.cabac.rate import RateEstimator
    from turingcodec_tpu_torch.encode.ctu_write import residual_core

    rng = np.random.default_rng(100 * log2 + 10 * scan + c_idx)
    for density in (0.05, 0.3, 0.9):
        blk = _random_block(rng, log2, density)
        ctx_a = ContextPool()
        ctx_a.initialize(1, 30)
        ctx_b = ctx_a.copy()
        est = RateEstimator(ctx_a)
        residual_core(est, blk, log2, c_idx, scan, False)
        got = native.residual_bits(ctx_b, log2, c_idx, scan, False, blk)
        assert got == pytest.approx(est.bits)
        assert ctx_a.states == ctx_b.states
        # the JAX package's pure-Python oracle gives the same bits
        ctx_j = JContextPool()
        ctx_j.initialize(1, 30)
        est_j = JRateEstimator(ctx_j)
        j_residual_core(est_j, blk, log2, c_idx, scan, False)
        assert est_j.bits == est.bits
        assert bytes(ctx_j.states) == bytes(ctx_a.states)


@pytest.mark.parametrize("stream", ["vfy_hp.hevc", "vfy_wp.hevc",
                                    "static_test.hevc"])
def test_decode_matches_python_and_golden(lib, stream):
    """tests/streams decoded with the native core and with the pure-Python
    path (TURING_TPU_NO_NATIVE): both equal GOLDEN.json, hash-clean."""
    from turingcodec_tpu_torch.tools.testdecode import decode_md5
    path = STREAMS / stream
    got_native = decode_md5(path, None, None)
    os.environ["TURING_TPU_NO_NATIVE"] = "1"
    native._TRIED, native._LIB = False, None
    try:
        got_python = decode_md5(path, None, None)
    finally:
        del os.environ["TURING_TPU_NO_NATIVE"]
        native._TRIED, native._LIB = False, None
    assert got_native == got_python
    md5, frames, hash_failures = got_native
    assert md5 == GOLDEN[stream] and frames > 0 and hash_failures == 0


def test_satd_simd_matches_scalar(lib):
    """The AVX2 SATD (enc_core satd8/4_avx2) equals the scalar Hadamard
    (satd_block_t), 8- and 10-bit ranges."""
    import ctypes
    rng = np.random.default_rng(21)
    for name in ("tc_test_satd", "tc_test_satd_scalar"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    for bs in (4, 8):
        for hi in (256, 1024):
            for _ in range(100):
                a = np.ascontiguousarray(rng.integers(0, hi, (bs, bs)),
                                         np.int32)
                b = np.ascontiguousarray(rng.integers(0, hi, (bs, bs)),
                                         np.int32)
                assert (lib.tc_test_satd(a.ctypes.data, b.ctypes.data, bs)
                        == lib.tc_test_satd_scalar(a.ctypes.data,
                                                   b.ctypes.data, bs))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("bd", [8, 10])
def test_fwd_transform_folded_matches_oracle(lib, n, bd):
    """The even/odd-folded native forward DCT (and the 4x4 DST) equals the
    port's numpy oracle."""
    import ctypes

    from turingcodec_tpu_torch.ops.transform import forward_transform_np
    lib.tc_test_fwd_transform.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    rng = np.random.default_rng(10 * n + bd)
    hi = (1 << bd) - 1
    for use_dst in ((0, 1) if n == 4 else (0,)):
        for i in range(25):
            res = np.ascontiguousarray(rng.integers(-hi, hi + 1, (n, n)),
                                       np.int32)
            if i == 0:    # the HM range's ends, in a checkerboard
                res = np.ascontiguousarray(np.where(
                    np.indices((n, n)).sum(0) % 2, hi, -hi), np.int32)
            out = np.zeros((n, n), np.int32)
            lib.tc_test_fwd_transform(res.ctypes.data, n, bd, use_dst,
                                      out.ctypes.data)
            np.testing.assert_array_equal(out, np.asarray(
                forward_transform_np(res, bd, bool(use_dst)), np.int32))


def _yuv(frames_y, w, h, chroma):
    """4:2:0 8-bit frames from luma planes and one chroma function."""
    out = []
    for i, y in enumerate(frames_y):
        u = np.asarray(chroma(i), np.uint8)
        out.append(np.clip(y, 0, 255).astype(np.uint8).tobytes()
                   + u.tobytes() + u.tobytes())
    return b"".join(out)


def _encode(raw, n_frames, **cfg):
    from turingcodec_tpu_torch.encode.encoder import (EncoderConfig,
                                                      encode_yuv_stream)
    bs, md5 = encode_yuv_stream(raw, EncoderConfig(device=None, **cfg),
                                n_frames=n_frames)
    return hashlib.md5(bs).hexdigest(), md5


def _wpp_raw(w, h, n_frames):
    """Textured luma moving by (2, 3) samples a frame, with noise, and
    noisy chroma."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h, w), np.int32)
    return _yuv([np.roll(base, (2 * i, 3 * i), (0, 1))
                 + rng.integers(-4, 5, (h, w)) for i in range(n_frames)],
                w, h, lambda i: rng.integers(100, 156, (h // 2, w // 2)))


_WPP_SEQUENTIAL = {}


def _wpp_encode(monkeypatch, w, h, ctb_log2, threads):
    """An IDR and 3 P pictures coded with `threads` row threads: the
    stream's MD5 and the reconstruction's."""
    n_frames = 4
    monkeypatch.setenv("TURING_TPU_ENC_THREADS", str(threads))
    return _encode(_wpp_raw(w, h, n_frames), n_frames, width=w, height=h,
                   ctb_log2=ctb_log2, qp=30, rd_candidates=1,
                   search_range=32, sdh=False)


@pytest.mark.parametrize("w, h, ctb_log2, threads", [
    (192, 192, 6, 3),     # 3x3 CTUs: a row for every thread
    (192, 448, 6, 2), (192, 448, 6, 3), (192, 448, 6, 4),  # 7 rows
    (192, 192, 5, 2), (192, 192, 5, 3), (192, 192, 5, 4),  # 6 rows
    (192, 448, 5, 12),    # 14 rows, more threads than the cores
])
def test_wpp_row_threads_bit_identical(lib, monkeypatch, w, h, ctb_log2,
                                       threads):
    """Wavefront row threads (tc_enc_picture with nthreads > 1) give the
    bitstream and reconstruction of the sequential walk, as the reference's
    signature rows share one hash across thread counts. With more rows
    than threads, rows move between threads at CTU boundaries."""
    key = (w, h, ctb_log2)
    if key not in _WPP_SEQUENTIAL:
        _WPP_SEQUENTIAL[key] = _wpp_encode(monkeypatch, w, h, ctb_log2, 1)
    assert _wpp_encode(monkeypatch, w, h, ctb_log2, threads) \
        == _WPP_SEQUENTIAL[key]


def _pan(seed, w, h, n_frames, dy, dx):
    """Luma windows panning over a random picture twice the size."""
    base = np.random.default_rng(seed).integers(0, 256, (2 * h, 2 * w),
                                                np.int32)
    return _yuv([base[h // 2 + dy * i:h // 2 + dy * i + h,
                      w // 2 + dx * i:w // 2 + dx * i + w]
                 for i in range(n_frames)], w, h,
                lambda i: np.full((h // 2, w // 2), 128))


def _drift(seed, w, h, n_frames, prepare, dy, dx):
    """A random picture (shaped by prepare) rolled by (dy, dx) per frame,
    with noise, and noisy chroma."""
    rng = np.random.default_rng(seed)
    base = prepare(rng, rng.integers(0, 256, (h, w), np.int32))
    return _yuv([np.roll(base, (dy * i, dx * i), (0, 1))
                 + rng.integers(-3, 4, (h, w)) for i in range(n_frames)],
                w, h, lambda i: rng.integers(100, 156, (h // 2, w // 2)))


def _detail(rng, base):
    base[8:40, 8:40] = rng.integers(0, 256, (32, 32))
    return base


def _flat_left(rng, base):
    base[:, :40] = (base[:, :40] // 16) * 16
    return base


def _gradient(w, h, n_frames):
    yy, xx = np.mgrid[0:h, 0:w]
    return _yuv([(xx + yy * 2 + i * 5) // 3 % 256 for i in range(n_frames)],
                w, h, lambda i: np.full((h // 2, w // 2), 128))


# (name, raw frames, frames, config): the native CTU search against the
# pure-Python searcher
ENCODER_CASES = {
    # a 14 px/frame pan, beyond the MET probes: the star's first pass wins
    # from far out and the lowres seeds are consulted
    "far_pan_met": (lambda: _pan(11, 192, 128, 3, 14, 9), 3, dict(
        width=192, height=128, qp=30, rd_candidates=1, search_range=32,
        sdh=False, met=True)),
    # RQT, slow preset: the native split-TU trial on high-detail content
    "rqt_slow": (lambda: _drift(23, 128, 64, 3, _detail, 0, 3), 3, dict(
        width=128, height=64, qp=27, rd_candidates=3, search_range=16)),
    # medium preset with APS and ESD active
    "aps_medium": (lambda: _drift(31, 128, 64, 3, _flat_left, 2, 5), 3,
                   dict(width=128, height=64, qp=30, rd_candidates=2,
                        search_range=16)),
    # hierarchical B with RDOQ at a MET preset: list 1's seeds are computed
    # in-picture where the installed field covers list 0's plane only
    "bpic_seed_install": (lambda: _pan(47, 192, 128, 5, 12, 8), 5, dict(
        width=192, height=128, qp=30, rd_candidates=2, search_range=32,
        met=True, rdoq=True, gop_m=4)),
    # 64x64 intra CUs on a drifting gradient (checked below to win)
    "intra64": (lambda: _gradient(192, 128, 3), 3, dict(
        width=192, height=128, qp=37, rd_candidates=3, search_range=16,
        gop_m=4, rdoq=True, sdh=True)),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_native_python_encoder_bit_identical(lib, monkeypatch, case):
    """The native CTU search (enc_core.cpp) and the pure-Python searcher
    (TURING_TPU_NO_NATIVE_ENC) give byte-identical bitstreams and recons."""
    make, n_frames, cfg = ENCODER_CASES[case]
    raw = make()
    got_native = _encode(raw, n_frames, **cfg)
    monkeypatch.setenv("TURING_TPU_NO_NATIVE_ENC", "1")
    assert _encode(raw, n_frames, **cfg) == got_native
    if case == "intra64":
        # the 64x64 intra trial wins somewhere: without it the stream
        # changes
        monkeypatch.delenv("TURING_TPU_NO_NATIVE_ENC")
        monkeypatch.setenv("TC_NO_I64", "1")
        assert _encode(raw, n_frames, **cfg)[0] != got_native[0]
