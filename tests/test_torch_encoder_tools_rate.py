"""Port twins of the JAX package's rate, GOP and AQ tests that need no
absent oracle (the caminandes clip, the reference binary), on synthetic
sequences:

- tests/test_rate_invariant.py: the search's committed per-CTU rate
  equals a writer re-walk of the final plan, integer-exactly, and the
  bytes are the JAX encoder's;
- tests/test_gop_scd.py: GOP sizes 3/5/6/7 round trip (bytes equal to
  the JAX encoder's, decoded hash-clean by the port), the lookahead
  shot-change detector places an IDR on a cut and none on smooth content;
- tests/test_aq_percu.py: per-CU AQ signals sub-CTB QP deltas, decodes
  hash-clean, the native and pure-Python searchers agree byte for byte,
  and depth 0 gives another stream;
- tests/test_ctu_rc.py: a 120-frame CBR encode within 2% of its target
  with no CPB underflow or overflow, and a CTU-RC stream whose decode
  equals the encoder's recon; both streams are the JAX encoder's."""
import numpy as np
import pytest

from tests.test_gop_scd import _frames as gop_frames
from tests.test_rate_invariant import _frames as rate_frames
from tests.test_torch_encoder_tools import _env, jax_encode
from turingcodec_tpu_torch.decode.decoder import Decoder
from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
from turingcodec_tpu_torch.encode.rate_check import writer_walk_frac
from turingcodec_tpu_torch.tools import tool_matrix as tm


def _port(**kw):
    return Encoder(EncoderConfig(device=None, **kw))


# -- tests/test_rate_invariant.py --------------------------------------

def _check_rate(cfg, frames):
    enc = _port(**cfg)
    out = [enc.headers()]
    per_pic = []
    for f in frames:
        for (_i, nal, _r) in enc.push_frame([p.copy() for p in f]):
            out.append(nal)
            per_pic.append((enc._last_plan, enc._last_sh,
                            enc._last_ctu_frac))
    for (_i, nal, _r) in enc.flush():
        out.append(nal)
        per_pic.append((enc._last_plan, enc._last_sh, enc._last_ctu_frac))
    assert per_pic, "no pictures encoded"
    for pi, (plan, sh, frac) in enumerate(per_pic):
        walk = writer_walk_frac(plan, enc.geom, sh)
        assert len(frac) == len(walk) != 0, (pi, len(frac), len(walk))
        assert list(frac) == list(walk), f"picture {pi}"
    assert b"".join(out) == jax_encode(frames, **cfg)


@pytest.mark.parametrize("rdoq", [False, True])
def test_rate_invariant_intra(rdoq):
    _check_rate(dict(width=96, height=64, qp=30, gop_m=1, intra_period=1,
                     sao=False, rdoq=rdoq, sdh=rdoq), rate_frames(2, 96, 64))


def test_rate_invariant_inter_ldp():
    _check_rate(dict(width=96, height=64, qp=32, gop_m=1, sao=False),
                rate_frames(4, 96, 64))


def test_rate_invariant_inter_b_slow():
    _check_rate(dict(width=96, height=64, qp=30, gop_m=4, sao=False,
                     rd_candidates=3, rdoq=True, sdh=True),
                rate_frames(5, 96, 64))


@pytest.mark.parametrize("gop_m", [3, 6])
def test_rate_invariant_odd_gops(gop_m):
    _check_rate(dict(width=96, height=64, qp=33, gop_m=gop_m, sao=False,
                     rd_candidates=2, rdoq=True, sdh=True),
                rate_frames(gop_m + 2, 96, 64))


def test_rate_invariant_python_oracle():
    with _env(TURING_TPU_NO_NATIVE="1"):
        _check_rate(dict(width=64, height=64, qp=34, gop_m=1, sao=False),
                    rate_frames(3, 64, 64))


def _rate_walks(mod, walk_frac, cfg, frames):
    """[(the search's committed per-CTU rate, the writer walk's)] per
    picture, with an encoder of either package."""
    enc = mod.Encoder(mod.EncoderConfig(**cfg))
    enc.headers()
    out = []
    for f in frames:
        for _r in enc.push_frame([p.copy() for p in f]):
            out.append((list(enc._last_ctu_frac), list(walk_frac(
                enc._last_plan, enc.geom, enc._last_sh))))
    return out


@pytest.mark.parametrize("name", ["aq-ctb", "aq-cu", "cbr-ctu-hrd",
                                  "cbr-picture"])
def test_rate_walk_under_the_tool_rows(name):
    """At the tool matrix's operating point without SAO (the walk covers
    no SAO syntax): picture-level rate control keeps the invariant; with
    cu_qp_delta on (AQ, CTU rate control) the search's committed rate
    falls short of the writer walk in the JAX package, a trait the port
    matches number for number (ROADMAP.md, known traits)."""
    import turingcodec_tpu.encode.encoder as jenc
    import turingcodec_tpu.encode.rate_check as jrc
    import turingcodec_tpu_torch.encode.encoder as tenc
    frames = rate_frames(3, 96, 64)
    cfg = {**tm.config(name, frames), "sao": False}
    got = _rate_walks(tenc, writer_walk_frac, {**cfg, "device": None},
                      frames)
    assert got == _rate_walks(jenc, jrc.writer_walk_frac, cfg, frames)
    assert len(got) == 3
    assert all((frac == walk) == (name == "cbr-picture")
               for frac, walk in got)


# -- tests/test_gop_scd.py ---------------------------------------------

def _gop_encode(frames, w, h, **kw):
    cfg = dict(width=w, height=h, qp=34, sao=False, **kw)
    enc = _port(**cfg)
    out = [enc.headers()]
    idxs = []
    for f in frames:
        for (i, nal, _r) in enc.push_frame([p.copy() for p in f]):
            out.append(nal)
            idxs.append(i)
    for (i, nal, _r) in enc.flush():
        out.append(nal)
        idxs.append(i)
    bs = b"".join(out)
    assert bs == jax_encode(frames, **cfg)
    return bs, idxs, enc


@pytest.mark.parametrize("gop_m", [3, 5, 6, 7])
def test_gop_sizes_roundtrip(gop_m):
    n = gop_m * 2 + 1
    bs, idxs, _ = _gop_encode(gop_frames(n, 96, 64), 96, 64, gop_m=gop_m)
    assert sorted(idxs) == list(range(n))
    dec = Decoder(device=None)
    assert sum(1 for _ in dec.decode_stream(bs)) == n
    assert dec.hash_failures == 0


def test_scd_lookahead_idr_on_cut():
    cut = 13
    frames = gop_frames(30, 96, 64, cut_at=cut)
    bs, idxs, enc = _gop_encode(frames, 96, 64, gop_m=4, shot_change=True,
                                hash_type=None)
    assert enc._scd.is_shot_change(cut)
    assert sorted(idxs) == list(range(30))
    assert sum(1 for _ in Decoder(device=None).decode_stream(bs)) == 30
    # one IDR NAL unit (types 19/20) for input 0, one for the cut
    assert tm.stream_facts(bs)["idr"] == 2
    # the tool matrix's scene is this one
    assert all(np.array_equal(a, b) for fa, fb in zip(
        frames, tm.cut_frames(30, 96, 64)) for a, b in zip(fa, fb))


def test_scd_no_false_cut_on_smooth_content():
    _bs, _idxs, enc = _gop_encode(gop_frames(24, 96, 64), 96, 64, gop_m=4,
                                  shot_change=True, hash_type=None)
    assert not any(enc._scd.flags.values()), enc._scd.flags


# -- tests/test_aq_percu.py and tests/test_ctu_rc.py, synthetic --------

def _textured(n, w, h, seed=3):
    """Noise whose amplitude changes every 16x16 block (so AQ's activity
    pyramid is not flat), panning by (1, 2) samples a frame."""
    rng = np.random.RandomState(seed)
    amp = np.kron(rng.randint(2, 64, ((h + 64) // 16, (w + 64) // 16)),
                  np.ones((16, 16), int))
    base = (128 + (rng.rand(h + 64, w + 64) - 0.5) * 2 * amp).clip(
        0, 255).astype(np.int16)
    out = []
    for i in range(n):
        y, x = i % 32, (2 * i) % 64
        out.append([np.ascontiguousarray(base[y:y + h, x:x + w]),
                    np.ascontiguousarray(base[:h // 2, :w // 2]),
                    np.ascontiguousarray(base[8:8 + h // 2, :w // 2])])
    return out


def _aq(frames, depth, **env):
    cfg = dict(width=128, height=64, qp=32, rd_candidates=1, search_range=32,
               gop_m=1, sao=False, aq_strength=1.0, aq_depth=depth)
    with _env(**env):
        return tm.encode(_port(**cfg), frames)[:2]


def test_percu_aq_roundtrip_and_twin_parity():
    frames = _textured(3, 128, 64)
    bs, plans = _aq(frames, 2)
    # sub-CTB QP variation exists (the pyramid is not flat on this content)
    assert any(len(np.unique(p.qp_y[ry * 16:(ry + 1) * 16,
                                    rx * 16:(rx + 1) * 16])) > 1
               for p in plans for ry in range(p.qp_y.shape[0] // 16)
               for rx in range(p.qp_y.shape[1] // 16))
    dec = Decoder(device=None)
    assert sum(1 for _ in dec.decode_stream(bs)) == 3
    assert dec.hash_failures == 0
    assert _aq(frames, 2, TURING_TPU_NO_NATIVE="1")[0] == bs
    assert _aq(frames, 0)[0] != bs
    assert bs == jax_encode(frames, width=128, height=64, qp=32,
                            rd_candidates=1, search_range=32, gop_m=1,
                            sao=False, aq_strength=1.0, aq_depth=2)


def test_cbr_120_frames_within_2pct_and_cpb_conformant():
    target, fr, n = 200_000.0, 24.0, 120
    cfg = dict(width=160, height=96, qp=32, rd_candidates=1, gop_m=1,
               bitrate=target, frame_rate=fr, hash_type=None,
               search_range=16, intra_period=48)
    enc = _port(**cfg)
    frames = _textured(n, 160, 96)
    stream, plans, _ = tm.encode(enc, frames)
    assert stream == jax_encode(frames, **cfg)
    achieved = 8 * len(stream) * fr / n
    assert abs(achieved - target) / target < 0.02, achieved
    assert enc._cpb.underflows == 0 and enc._cpb.overflows == 0
    # the controller moves the QP inside a picture
    assert max(len(np.unique(p.qp_y)) for p in plans) > 1
    dec = Decoder(device=None)
    assert sum(1 for _ in dec.decode_stream(stream)) == n
    assert not dec.violations


def test_ctu_rc_roundtrip_recon_exact():
    cfg = dict(width=160, height=96, qp=34, rd_candidates=1, gop_m=1,
               bitrate=250_000.0, frame_rate=24.0, search_range=16)
    enc = _port(**cfg)
    frames = _textured(6, 160, 96)
    stream = enc.headers()
    recons = []
    for f in frames:
        for r in enc.push_frame([p.copy() for p in f]):
            stream += r[1]
            recons.append(r[2])
    assert stream == jax_encode(frames, **cfg)
    dec = Decoder(device=None)
    out = list(dec.decode_stream(stream))
    assert len(out) == 6 and dec.hash_failures == 0
    for f, r in zip(out, recons):
        for a, b in zip(f.planes, r):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
