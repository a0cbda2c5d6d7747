"""The decoder's loop filters in the port (turingcodec_tpu_torch.ops.deblock
and .ops.sao) against the JAX package's device programs, on inputs made
from a seed by tools/loop_filter_check.py: random TU, PU and CU layouts,
intra and inter blocks with coded-block flags, reference indices, POCs and
motion vectors, QPs over the whole range, slices with deblocking disabled
in one and filtering across slices off in another, tiles, beta and tc
offsets of +-12; SAO maps of every type, band position and edge class,
slices, tiles and the skip map. 8, 10, 12 (deblocking), 13, 14 and 16
bits, and sides that are no multiple of 16; at 16 bits the planes are
int16 as the JAX pipeline holds them (a sample above 32767 wraps
negative, and both packages filter the wrapped values alike). Every
value is an integer: equality is exact (tolerance 0). On CPU tensors the wrappers run the plain versions (deblock_device_ref,
_sao_plane) and count no launch.

The cases marked `cuda` hold the CUDA kernels against the plain versions
on the card and skip without one; this file imports the JAX package only
in the fixture of the CPU cases, so they run on a machine without it:
python -m pytest --noconftest -m cuda tests/test_torch_loop_filter_kernels.py
"""
import os

import numpy as np
import pytest
import torch

import turingcodec_tpu_torch.decode.device_pipeline as dp
from turingcodec_tpu_torch.decode.decoder import Decoder
from turingcodec_tpu_torch.ops import deblock as tdb
from turingcodec_tpu_torch.ops import sao as tsao
from turingcodec_tpu_torch.parallel import gop_decode as tgop
from turingcodec_tpu_torch.tools.loop_filter_check import (deblock_synthetic,
                                                           sao_synthetic)

STREAMS = os.path.join(os.path.dirname(__file__), "streams")


@pytest.fixture(scope="module")
def jax_ops():
    import jax.numpy as jnp

    import turingcodec_tpu.ops.deblock as jdb
    import turingcodec_tpu.ops.sao as jsao
    return jnp, jdb, jsao


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _deblock_torch(planes, maps, sl, ctb_log2, bd, across):
    return tdb.deblock_device(*(_t(p) for p in planes),
                              tuple(_t(m) for m in maps),
                              tuple(_t(v) for v in sl), ctb_log2, bd, bd,
                              across)


# (h, w): 72x40 and 136x88 have sides that are no multiple of 16 (the last
# chroma window runs past the plane), 64x1080 is a strip as high as 1080p
DEBLOCK_SIZES = [(40, 72), (88, 136), (1080, 64)]


# the loop filters' bit depths; 16 under the int16 convention
DEBLOCK_BDS = [8, 10, 12, 13, 14, 16]
CTB_LOG2 = {8: 4, 10: 5, 12: 6, 13: 4, 14: 5, 16: 6}


@pytest.mark.parametrize("bd", DEBLOCK_BDS)
@pytest.mark.parametrize("hw", DEBLOCK_SIZES)
def test_deblock_plain_matches_jax(jax_ops, hw, bd):
    jnp, jdb, _ = jax_ops
    h, w = hw
    ctb_log2 = CTB_LOG2[bd]
    rng = np.random.default_rng(1000 * bd + h)
    planes, maps, sl, across = deblock_synthetic(rng, h, w, bd,
                                                 ctb_log2=ctb_log2)
    tdb.launches = 0
    got = _deblock_torch(planes, maps, sl, ctb_log2, bd, across)
    want = jdb.deblock_device(*(jnp.asarray(p) for p in planes),
                              tuple(jnp.asarray(m) for m in maps),
                              tuple(jnp.asarray(v) for v in sl), ctb_log2,
                              bd, bd, jnp.asarray(across))
    for g, wnt, p in zip(got, want, planes):
        assert g.dtype == torch.int16
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    # the filters changed something
    assert any(not np.array_equal(g.numpy(), p)
               for g, p in zip(got, planes))
    assert tdb.launches == 0


@pytest.mark.parametrize("case", ["across tiles", "one slice, 8x8 CTB "
                                  "grid", "chroma 10 luma 8"])
def test_deblock_plain_matches_jax_variants(jax_ops, case):
    jnp, jdb, _ = jax_ops
    rng = np.random.default_rng(7)
    bd_y, bd_c, ctb_log2, n_sl, across = 8, 8, 4, 4, False
    if case == "across tiles":
        across = True
    elif case.startswith("one slice"):
        ctb_log2, n_sl = 3, 1
    else:
        bd_c = 10
    planes, maps, sl, _ = deblock_synthetic(rng, 48, 104, bd_y, bd_c,
                                            ctb_log2=ctb_log2,
                                            n_slices=n_sl)
    got = tdb.deblock_device(*(_t(p) for p in planes),
                             tuple(_t(m) for m in maps),
                             tuple(_t(v) for v in sl), ctb_log2, bd_y, bd_c,
                             across)
    want = jdb.deblock_device(*(jnp.asarray(p) for p in planes),
                              tuple(jnp.asarray(m) for m in maps),
                              tuple(jnp.asarray(v) for v in sl), ctb_log2,
                              bd_y, bd_c, jnp.asarray(across))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_deblock_frames_equal_per_picture_calls():
    """deblock_frames (gop_deblock) on the CPU: three synthetic pictures
    with per-picture across-tiles flags, each equal to its own call."""
    pics = [deblock_synthetic(np.random.default_rng(50 + i), 48, 80, 10,
                              ctb_log2=4) for i in range(3)]
    across = torch.tensor([True, False, True])
    tdb.launches = 0
    got = tgop.gop_deblock(
        *(torch.stack([_t(p[0][k]) for p in pics]) for k in range(3)),
        tuple(torch.stack([_t(p[1][k]) for p in pics]) for k in range(11)),
        tuple(torch.stack([_t(p[2][k]) for p in pics]) for k in range(6)),
        across, 4, 10, 10)
    for i, (planes, maps, sl, _) in enumerate(pics):
        want = _deblock_torch(planes, maps, sl, 4, 10, bool(across[i]))
        assert all(torch.equal(g[i], wnt) for g, wnt in zip(got, want))
    assert tdb.launches == 0


def _sao_jax(jax_ops, args):
    jnp, _, jsao = jax_ops
    (src, ctb, bd, sub, st, sc, so, slc, tile, en, ac, at, skip) = args
    h, w = src.shape
    k = 4 // sub

    def up(m, f):
        return jnp.asarray(np.repeat(np.repeat(m, f, 0), f, 1)[:h, :w])
    return np.asarray(jsao._sao_plane(
        jnp.asarray(src), ctb, bd, sub, jnp.asarray(st), jnp.asarray(sc),
        jnp.asarray(so), up(slc, ctb), up(tile, ctb), jnp.asarray(en),
        jnp.asarray(ac), jnp.asarray(at), up(skip, k)))


def _frames(args):
    """sao_synthetic's arguments with a frame axis of 1, as tensors."""
    return [_t(a)[None] if isinstance(a, np.ndarray) else a for a in args]


# (h, w, ctb): every side is no multiple of its CTB
SAO_SIZES = [(40, 72, 16), (44, 68, 32), (136, 200, 64)]


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("bd", [8, 10, 13, 14, 16])
@pytest.mark.parametrize("size", SAO_SIZES)
def test_sao_plain_matches_jax(jax_ops, size, bd, sub):
    h, w, ctb = size
    rng = np.random.default_rng(bd * 100 + h + sub)
    args = sao_synthetic(rng, h, w, bd, ctb // sub, sub)
    tsao.launches = 0
    got = tsao.sao_frames(*_frames(args))[0]
    want = _sao_jax(jax_ops, args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, args[0])
    assert tsao.launches == 0
    # every type and edge class is present
    st, sc = args[4], args[5]
    assert set(np.unique(st)) == {0, 1, 2}
    assert set(np.unique(sc[st == 2])) <= {0, 1, 2, 3}


@pytest.mark.parametrize("eo", [0, 1, 2, 3])
def test_sao_edge_class_matches_jax(jax_ops, eo):
    """One edge class on every CTB, across-slices off, tiles off: the
    neighbour rules of that direction on every boundary."""
    rng = np.random.default_rng(40 + eo)
    args = list(sao_synthetic(rng, 48, 80, 8, 16, 1))
    args[4] = np.full_like(args[4], 2)
    args[5] = np.full_like(args[5], eo)
    args[10] = np.zeros_like(args[10])
    args[11] = False
    got = tsao.sao_frames(*_frames(args))[0]
    np.testing.assert_array_equal(got.numpy(), _sao_jax(jax_ops, args))


def test_sao_ctb_maps_are_strided_views_of_the_upsampled_ones():
    """gop_sao reads the per-CTB maps back from the sample-resolution ones
    by strided views: upsampled again they are the maps gop_sao was given,
    and its result is the host decoder's."""
    with open(os.path.join(STREAMS, "vfy_sweep.hevc"), "rb") as f:
        pics = [p for p in tgop.capture_pictures(f.read(), max_frames=6)
                if p["sao"] is not None][:2]
    for c_idx in range(3):
        stacked, (ctb, bd, sub), per = tgop.sao_inputs(pics, c_idx, "cpu")
        k = 4 // sub
        h, w = stacked[0].shape[1:]
        for i in range(len(pics)):
            for up, step in ((stacked[4], ctb), (stacked[5], ctb),
                             (stacked[9], k)):
                assert torch.equal(tsao._up(up[i, ::step, ::step], step,
                                            step, h, w), up[i])
        got = tgop.gop_sao(*stacked, ctb=ctb, bd=bd, sub=sub)
        np.testing.assert_array_equal(got.numpy(), np.stack(
            [p["sao"][c_idx] for p in pics]))


def test_cpu_tensors_count_no_launch(monkeypatch):
    monkeypatch.setattr(tdb, "launches", 0)
    monkeypatch.setattr(tsao, "launches", 0)
    got = Decoder(device="cpu").decode_stream(
        open(os.path.join(STREAMS, "vfy_sweep.hevc"), "rb").read(),
        max_frames=3)
    assert sum(1 for _ in got) == 3
    assert tdb.launches == 0 and tsao.launches == 0


def test_cuda_requests_without_a_card_raise():
    """The picture-level entry points hand tensors that are not on the CPU
    to the wrappers, which refuse a device other than CUDA themselves (no
    plain version runs there); with no card a CUDA request raises and
    filters nothing."""
    with open(os.path.join(STREAMS, "vfy_sweep.hevc"), "rb") as f:
        pic = tgop.capture_pictures(f.read(), max_frames=1)[0]
    plan, geom = pic["plan"], pic["geom"]
    with pytest.raises(ValueError, match="unsupported device meta"):
        tdb.deblock_picture_device(plan, geom, *(p.copy() for p in
                                                 pic["pre"]), "meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tsao.sao_picture_device(plan, geom, pic["post"], "meta")
    if torch.cuda.is_available():
        return
    planes = [p.copy() for p in pic["pre"]]
    with pytest.raises((RuntimeError, AssertionError)):
        tdb.deblock_picture_device(plan, geom, *planes, "cuda")
    assert all(np.array_equal(a, b) for a, b in zip(planes, pic["pre"]))
    with pytest.raises((RuntimeError, AssertionError)):
        tsao.sao_picture_device(plan, geom, pic["post"], "cuda")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.device("meta")
    planes, maps, sl, _ = deblock_synthetic(np.random.default_rng(3), 40,
                                            72, 8)
    with pytest.raises(ValueError):
        tdb.deblock_frames(*(_t(p)[None].to(meta) for p in planes),
                           tuple(_t(m)[None].to(meta) for m in maps),
                           tuple(_t(v)[None].to(meta) for v in sl), 4, 8, 8,
                           False)
    args = _frames(sao_synthetic(np.random.default_rng(3), 40, 72, 8, 16))
    with pytest.raises(ValueError):
        tsao.sao_frames(*[a.to(meta) if isinstance(a, torch.Tensor) else a
                          for a in args])


def test_pipeline_stage_trace(monkeypatch, capsys):
    """TURING_TPU_PIPELINE_TRACE: every stage of every picture through the
    pipeline is timed and printed, and the decode is unchanged."""
    monkeypatch.setenv("TURING_TPU_PIPELINE_TRACE", "1")
    monkeypatch.setattr(dp, "stage_seconds", {})
    monkeypatch.setattr(dp, "pictures", 0)
    data = open(os.path.join(STREAMS, "vfy_sweep.hevc"), "rb").read()
    got = [f.planes for f in Decoder(device="cpu").decode_stream(
        data, max_frames=3)]
    want = [f.planes for f in Decoder(device=None).decode_stream(
        data, max_frames=3)]
    assert all(np.array_equal(a, b) for fa, fb in zip(got, want)
               for a, b in zip(fa, fb))
    stages = ("mc", "residual", "intra", "deblock", "sao", "pull")
    assert set(dp.stage_seconds) == set(stages)
    assert all(v >= 0 for v in dp.stage_seconds.values())
    err = capsys.readouterr().err
    for tag in stages:
        assert err.count(f"[pipeline] {tag}") == dp.pictures >= 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bd", DEBLOCK_BDS)
def test_deblock_kernel_matches_plain_on_card(bd):
    dev = _card()
    rng = np.random.default_rng(bd)
    planes, maps, sl, across = deblock_synthetic(rng, 88, 136, bd,
                                                 ctb_log2=4)
    tdb.launches = 0
    got = tdb.deblock_device(*(_t(p).to(dev) for p in planes),
                             tuple(_t(m).to(dev) for m in maps),
                             tuple(_t(v).to(dev) for v in sl), 4, bd, bd,
                             across)
    want = _deblock_torch(planes, maps, sl, 4, bd, across)
    assert all(torch.equal(g.cpu(), wnt) for g, wnt in zip(got, want))
    assert tdb.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 13, 14, 16])
def test_sao_kernel_matches_plain_on_card(bd):
    dev = _card()
    for sub in (1, 2):
        args = _frames(sao_synthetic(np.random.default_rng(bd + sub),
                                     44, 68, bd, 16 // sub, sub))
        tsao.launches = 0
        got = tsao.sao_frames(*[a.to(dev) if isinstance(a, torch.Tensor)
                                else a for a in args])
        assert torch.equal(got.cpu(), tsao.sao_frames(*args))
        assert tsao.launches == 1
