"""The encoder's tool configurations (turingcodec_tpu_torch/tools/
tool_matrix.py: AQ per CTB and per CU, CBR at CTU and picture level with
HRD signalling, shot-change IDR placement; the tile, slice and
transform-skip rows are in the _tiles and _slices files) held against the
JAX package on each row's small input, tolerance 0:

- the port's bitstream with device=None and device="cpu" (the kernels'
  plain versions) equals the JAX encoder's with its analysis stage on
  (TURING_TPU_DEVICE_ENC=1), byte for byte;
- the port's decode on the same device equals the JAX decoder's, with no
  hash failure, every picture through the "cpu" pipeline;
- the stream reaches the row's tool (tool_matrix.reach).

Also the port twins of tests/test_encoder_tools.py (AQ round trip, rate
control, shot change in low delay, field coding, HRD signalling,
frame-parallel bit identity, noise-adaptive RDOQ persistence), and (a
slow test) the pinned goldens re-derived from the JAX package on the
rows' card inputs."""
import contextlib
import hashlib
import os

import numpy as np
import pytest

from turingcodec_tpu_torch.tools import tool_matrix as tm
from turingcodec_tpu_torch.tools.device_enc_check import decode_inputs

ROWS = ["aq-ctb", "aq-cu", "cbr-ctu-hrd", "cbr-picture", "scd-gop4"]


@contextlib.contextmanager
def _env(**kw):
    """Set environment variables for the block, restoring them after."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_encode(frames, device_enc=False, **cfg):
    """The JAX encoder's bitstream of `frames` (its analysis stage on
    where `device_enc`, as the port's device="cpu" runs)."""
    import turingcodec_tpu.encode.encoder as jenc
    with _env(**({"TURING_TPU_DEVICE_ENC": "1"} if device_enc else {})):
        return tm.encode(jenc.Encoder(jenc.EncoderConfig(**cfg)), frames)[0]


def jax_row(name, frames):
    """The JAX package's encode of the row (analysis stage on) and its
    decode: (bitstream, planes of each frame)."""
    from turingcodec_tpu.decode.decoder import Decoder
    bs = jax_encode(frames, True, **tm.config(name, frames))
    dec = Decoder()
    planes = [[np.asarray(p) for p in f.planes]
              for f in dec.decode_stream(bs)]
    assert dec.hash_failures == 0 and not dec.violations
    return bs, planes


def check_row(name, device, clip, cache):
    """The port's encode and decode of the row on `device` against the
    JAX package's (computed once per row into `cache`)."""
    import turingcodec_tpu_torch.decode.device_pipeline as dp
    frames = tm.row_input(name, clip, small=True)
    if name not in cache:
        cache[name] = jax_row(name, frames)
    want_bs, want = cache[name]
    bs, plans, _ = tm.encode_row(name, frames, device)
    assert bs == want_bs, f"{name} on {device}: the bitstream differs"
    tm.reach(name, bs, plans)
    dp.pictures = dp.envelope_host = 0
    got, dec = tm.decode(bs, device)
    assert dec.hash_failures == 0 and not dec.violations
    assert len(got) == len(want) == len(frames)
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            np.testing.assert_array_equal(a, b)
    if device:
        assert (dp.pictures, dp.envelope_host) == (len(frames), 0)


@pytest.fixture(scope="module")
def clip():
    return decode_inputs(3, 1)


@pytest.fixture(scope="module")
def jax_cache():
    return {}


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("name", ROWS)
def test_tool_row_matches_jax(name, device, clip, jax_cache):
    check_row(name, device, clip, jax_cache)


def test_rows_cover_the_tool_matrix():
    """This file and the _tiles and _slices files hold every row."""
    from tests import (test_torch_encoder_tools_slices as sl,
                       test_torch_encoder_tools_tiles as ti)
    assert sorted(ROWS + ti.ROWS + sl.ROWS) == sorted(
        r.name for r in tm.ROWS)


def test_reach_refuses_a_row_that_misses_its_tool(clip):
    """A row whose stream does not show its tool fails: the same frames
    encoded without AQ give one QpY per picture."""
    frames = tm.row_input("aq-cu", clip, small=True)
    cfg = {**tm.config("aq-cu", frames), "aq_strength": 0.0}
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    bs, plans, _ = tm.encode(Encoder(EncoderConfig(**cfg, device=None)),
                             frames)
    with pytest.raises(RuntimeError, match="one QpY per picture"):
        tm.reach("aq-cu", bs, plans)
    with pytest.raises(RuntimeError, match="IDR NAL units"):
        tm.reach("scd-gop4", bs, plans)


@pytest.mark.slow
@pytest.mark.parametrize("name", [r.name for r in tm.ROWS])
def test_goldens_are_the_jax_packages_on_the_card_inputs(name):
    """Each row's pinned goldens are the JAX package's encode and decode
    of its card input (the 1080p rows take about a minute each)."""
    row = tm.BY_NAME[name]
    clip = decode_inputs(row.card[4], 3) if row.source == "main" else None
    bs, planes = jax_row(name, tm.row_input(name, clip))
    assert tm.hashes(bs, planes) == row.golden


# -- port twins of tests/test_encoder_tools.py -------------------------

def _synthetic_frame(w, h, seed):
    """tests/test_encoder.py::_synthetic_frame."""
    from tests.test_encoder import _synthetic_frame as make
    return make(w, h, seed)


def test_hrd_signalling():
    """CBR rate control writes VUI hrd_parameters (nal_hrd, cbr, 1 s CPB);
    the port's decoder parses them back; the bytes are the JAX encoder's."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    cfg = dict(width=64, height=64, qp=35, rd_candidates=1, gop_m=1,
               search_range=8, bitrate=100_000, frame_rate=25.0)
    f = _synthetic_frame(64, 64, 7)
    frames = [[np.roll(p, i, axis=0) for p in f] for i in range(3)]
    stream = tm.encode(Encoder(EncoderConfig(**cfg, device=None)),
                       frames)[0]
    assert stream == jax_encode(frames, **cfg)
    dec = Decoder(device=None)
    assert len(list(dec.decode_stream(stream))) == 3 and not dec.violations
    hrd = list(dec.ps.sps.values())[0].vui.hrd
    assert hrd is not None and hrd.nal_hrd_parameters_present_flag == 1
    sl = hrd.sub_layers[0]
    e = sl["nal_hrd"][0]
    assert e["cbr_flag"] == 1
    assert (e["bit_rate_value_minus1"] + 1) << (6 + hrd.bit_rate_scale) \
        == 99840  # 100 kb/s quantized to 256-bit units
    assert sl["fixed_pic_rate_general_flag"] == 1


def test_frame_parallel_bit_identical():
    """Frame-parallel encoding (1, 2 and 3 pictures in flight, per-picture
    native contexts) reproduces the sequential walk byte for byte, and the
    JAX package's default run."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    rng = np.random.default_rng(3)
    h, w = 96, 160
    prev = rng.integers(0, 255, (h + 64, w + 64), np.int16)
    frames = [[np.ascontiguousarray(prev[i * 2:i * 2 + h, i * 3:i * 3 + w]),
               np.full((h // 2, w // 2), 100, np.int16),
               np.full((h // 2, w // 2), 120, np.int16)] for i in range(9)]
    cfg = dict(width=w, height=h, qp=32, gop_m=8, rd_candidates=2)

    def run(ft):
        with _env(TURING_TPU_FRAME_THREADS=ft):
            return hashlib.md5(tm.encode(Encoder(EncoderConfig(
                **cfg, device=None)), frames)[0]).hexdigest()

    want = hashlib.md5(jax_encode(frames, **cfg)).hexdigest()
    assert run("1") == run("2") == run("3") == want


def test_noise_adaptive_rdoq_persistence(monkeypatch):
    """The dense-ME SAD median flips RDOQ to dead-zone quantization only
    after 2+ consecutive unpredictable inter pictures (white noise); a
    single unpredictable picture (a scene cut) keeps RDOQ. The analysis
    stage runs on "cpu"; the decisions and the bytes are the JAX
    encoder's with its analysis stage on."""
    import turingcodec_tpu.encode.inter_search as JIS
    import turingcodec_tpu_torch.encode.inter_search as IS
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    rng = np.random.RandomState(7)
    h, w = 96, 160
    flat = np.full((h, w), 128, np.int16)
    grad = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.int16)

    def noise():
        return np.clip(grad + rng.randint(-24, 25, (h, w)), 0,
                       255).astype(np.int16)

    decisions = {IS: [], JIS: []}

    def probe(mod):
        orig_na = mod.InterPictureEncoder._noise_adapt

        def noise_adapt(self, orig):
            r = orig_na(self, orig)
            decisions[mod].append(self.use_rdoq)
            return r
        monkeypatch.setattr(mod.InterPictureEncoder, "_noise_adapt",
                            noise_adapt)

    probe(IS)
    probe(JIS)
    cfg = dict(width=w, height=h, qp=32, gop_m=1, search_range=32,
               rd_candidates=1, rdoq=True, sdh=True)
    # IDR(flat), P flat (predictable), P cut to noise (one unpredictable),
    # then independent noise Ps (persistent)
    frames = [[y, np.full((h // 2, w // 2), 100, np.int16),
               np.full((h // 2, w // 2), 120, np.int16)]
              for y in [flat, flat.copy()] + [noise() for _ in range(4)]]
    stream = tm.encode(Encoder(EncoderConfig(**cfg, device="cpu")),
                       frames)[0]
    assert decisions[IS][:4] == [True, True, False, False]
    assert stream == jax_encode(frames, True, **cfg)
    assert decisions[JIS] == decisions[IS]


def test_aq_roundtrip():
    """AQ with real dQPs (a dark band): the port's decode equals the
    encoder's recon, hash-clean, and the bytes are the JAX encoder's."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    cfg = dict(width=128, height=64, qp=32, rd_candidates=1,
               aq_strength=1.0, gop_m=1, search_range=8)
    frames = []
    for i in range(3):
        f = [np.roll(p, i, axis=1) for p in _synthetic_frame(128, 64, 2)]
        f[0][:, :40] //= 4   # non-uniform activity -> real dQPs
        frames.append(f)
    enc = Encoder(EncoderConfig(**cfg, device=None))
    stream, recons = enc.headers(), []
    for f in frames:
        _, nal, recon = enc.push_frame([p.copy() for p in f])[0]
        stream += nal
        recons.append(recon)
    assert stream == jax_encode(frames, **cfg)
    out = list(Decoder(device=None).decode_stream(stream))
    assert len(out) == 3
    for f, r in zip(out, recons):
        assert f.hash_ok
        for a, b in zip(f.planes, r):
            np.testing.assert_array_equal(a, b)


def test_rate_control_converges():
    """The rate lands within a factor 2 of its target; the bytes are the
    JAX encoder's."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    w, h, n, target = 128, 64, 12, 200_000.0
    rng = np.random.default_rng(0)
    base = _synthetic_frame(w, h, 5)
    frames = [[np.clip(p + rng.integers(-3, 4, p.shape), 0, 255)
               .astype(np.int16) for p in base] for _ in range(n)]
    cfg = dict(width=w, height=h, qp=32, rd_candidates=1, gop_m=1,
               bitrate=target, frame_rate=24.0, hash_type=None,
               search_range=8)
    enc = Encoder(EncoderConfig(**cfg, device=None))
    hdr = enc.headers()
    stream = hdr + b"".join(r[1] for f in frames
                       for r in enc.push_frame([p.copy() for p in f]))
    bits = 8 * (len(stream) - len(hdr))
    assert 0.5 * target < bits * 24.0 / n < 2.0 * target
    assert stream == jax_encode(frames, **cfg)


def test_shot_change_places_idr():
    """The reference-parity detector (SCDetection.h) in low delay: a cut
    at frame 11 of 24 becomes the stream's second IDR."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    a = _synthetic_frame(64, 64, 0)
    b = _synthetic_frame(64, 64, 99)
    b[0][:] = 255 - b[0]
    frames = [a if i < 11 else b for i in range(24)]
    cfg = dict(width=64, height=64, qp=35, rd_candidates=1, gop_m=1,
               shot_change=True, search_range=8, hash_type=None)
    stream = tm.encode(Encoder(EncoderConfig(**cfg, device=None)),
                       frames)[0]
    assert stream == jax_encode(frames, **cfg)
    assert tm.stream_facts(stream)["idr"] == 2
    assert len(list(Decoder(device=None).decode_stream(stream))) == 24


def test_field_coding_roundtrip():
    """Field coding: each frame becomes two half-height field pictures
    with pic_timing pic_struct 1/2, VUI field_seq_flag and interlaced PTL
    flags; the port's decode equals the encoder's recon, and the bytes
    are the JAX encoder's."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    from turingcodec_tpu_torch.hevc import sei as S
    w, h = 64, 64
    cfg = dict(width=w, height=h, qp=35, rd_candidates=1, gop_m=1,
               search_range=8, field_coding=True)
    enc = Encoder(EncoderConfig(**cfg, device=None))
    stream = enc.headers()
    base = _synthetic_frame(w, h, 3)
    inputs = [[np.roll(p, i, axis=1) for p in base] for i in range(2)]
    recons = {}
    for f in inputs:
        for idx, nal, rec in enc.push_frame([p.copy() for p in f]):
            stream += nal
            recons[idx] = rec
    for idx, nal, rec in enc.flush():
        stream += nal
        recons[idx] = rec
    assert len(recons) == 4  # two fields per frame
    assert stream == jax_encode(inputs, **cfg)
    dec = Decoder(device=None)
    frames = list(dec.decode_stream(stream))
    assert len(frames) == 4 and not dec.violations
    sps = list(dec.ps.sps.values())[0]
    assert sps.vui.field_seq_flag == 1
    assert sps.ptl.general_interlaced_source_flag == 1
    assert sps.ptl.general_progressive_source_flag == 0
    assert [d["pic_struct"] for t, d in dec.sei_log
            if t == S.SEI_PIC_TIMING] == [1, 2, 1, 2]
    for i, f in enumerate(frames):
        assert f.planes[0].shape == (h // 2, w) and f.hash_ok
        for a, b in zip(f.planes, recons[i]):
            np.testing.assert_array_equal(a, b)
