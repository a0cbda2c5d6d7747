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


# the deblocking kernel's windows: a CTA owns the luma window
# [x0 - 4, x0 + T - 4) x [y0 - 4, y0 + T - 4) for x0, y0 multiples of T,
# and the chroma window [x0/2 - 2, x0/2 + T/2 - 2) likewise, clipped to
# the picture; 152x200 leaves ragged last windows at T = 32 and 64
WINDOW_PICTURE = (152, 200)


def _window(t, where):
    """(x0, y0) of the window at the picture's top-left corner, inside it,
    or its ragged bottom-right corner."""
    h, w = WINDOW_PICTURE
    return {"corner": (0, 0), "inner": (t, t),
            "ragged": (t * ((w + 3) // t), t * ((h + 3) // t))}[where]


def _noise_outside(rng, plane, bd, y_lo, y_hi, x_lo, x_hi):
    """plane with every sample outside [y_lo, y_hi) x [x_lo, x_hi)
    replaced by noise in range."""
    out = rng.integers(0, 1 << bd, plane.shape).astype(np.int16)
    out[max(y_lo, 0):y_hi, max(x_lo, 0):x_hi] = \
        plane[max(y_lo, 0):y_hi, max(x_lo, 0):x_hi]
    return out


@pytest.mark.parametrize("where", ["corner", "inner", "ragged"])
@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_window_depends_on_nothing_outside_it(bd, t, where):
    """The premise of the kernel's one launch: the filtered samples of a
    window (luma shifted by 4, chroma by 2) depend on that window's input
    samples alone, so windows filtered independently tile the output.
    Noise outside the window leaves deblock_device_ref's output inside it
    unchanged (slices, tiles, a disabled slice, +-12 offsets), and the
    filters do change samples there."""
    h, w = WINDOW_PICTURE
    rng = np.random.default_rng(100 * bd + t)
    planes, maps, sl, across = deblock_synthetic(rng, h, w, bd, ctb_log2=4)
    # the disabled slice moved from the last (the bottom rows, where the
    # ragged window lies) to the third
    sl = (np.roll(sl[0], -1),) + sl[1:]
    assert sl[0].tolist() == [False, False, True, False]
    x0, y0 = _window(t, where)
    luma = (y0 - 4, y0 + t - 4, x0 - 4, x0 + t - 4)
    chroma = (y0 // 2 - 2, y0 // 2 + t // 2 - 2, x0 // 2 - 2,
              x0 // 2 + t // 2 - 2)
    assert luma[0] < h and luma[2] < w
    noisy = [_noise_outside(rng, planes[0], bd, *luma)] + [
        _noise_outside(rng, p, bd, *chroma) for p in planes[1:]]
    want = _deblock_torch(planes, maps, sl, 4, bd, across)
    got = _deblock_torch(noisy, maps, sl, 4, bd, across)
    for k, (y_lo, y_hi, x_lo, x_hi) in enumerate([luma, chroma, chroma]):
        win = np.s_[max(y_lo, 0):y_hi, max(x_lo, 0):x_hi]
        np.testing.assert_array_equal(got[k].numpy()[win],
                                      want[k].numpy()[win])
        assert not np.array_equal(want[k].numpy()[win], planes[k][win])
    if where == "inner":
        # the window unshifted is not enough: noise at its left and top
        # borders reaches the filtered samples inside it
        bare = [_noise_outside(rng, planes[0], bd, y0, y0 + t, x0, x0 + t)]
        bare += [_noise_outside(rng, p, bd, y0 // 2, (y0 + t) // 2, x0 // 2,
                                (x0 + t) // 2) for p in planes[1:]]
        got = _deblock_torch(bare, maps, sl, 4, bd, across)
        for k, (y_lo, x_lo, n) in enumerate([(y0, x0, t)]
                                            + [(y0 // 2, x0 // 2, t // 2)] * 2):
            win = np.s_[y_lo:y_lo + n, x_lo:x_lo + n]
            assert not np.array_equal(got[k].numpy()[win],
                                      want[k].numpy()[win]), k


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
    assert tdb.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 16])
@pytest.mark.parametrize("hw", [(152, 200), (120, 136), (56, 40), (8, 8),
                                (16, 24)])
def test_deblock_kernel_ragged_windows_on_card(hw, bd):
    """The kernel's 64-sample windows where they are ragged: sides that
    are multiples of 8 but not of 16 or 64 (152x200, 120x136), and
    pictures smaller than one window (56x40, 16x24, and 8x8 with no edge
    at all, which the kernel copies)."""
    dev = _card()
    h, w = hw
    planes, maps, sl, across = deblock_synthetic(
        np.random.default_rng(h + w + bd), h, w, bd, ctb_log2=4)
    tdb.launches = 0
    got = tdb.deblock_device(*(_t(p).to(dev) for p in planes),
                             tuple(_t(m).to(dev) for m in maps),
                             tuple(_t(v).to(dev) for v in sl), 4, bd, bd,
                             across)
    want = _deblock_torch(planes, maps, sl, 4, bd, across)
    assert all(torch.equal(g.cpu(), wnt) for g, wnt in zip(got, want))
    assert tdb.launches == 1


@pytest.mark.cuda
def test_deblock_frames_batch_on_card():
    """deblock_frames over 3 pictures in one launch, with per-picture
    across-tiles flags, against per-picture plain calls; the inputs stay
    as they were."""
    dev = _card()
    pics = [deblock_synthetic(np.random.default_rng(60 + i), 88, 136, 10,
                              ctb_log2=4) for i in range(3)]
    across = torch.tensor([True, False, True])
    stacked = [torch.stack([_t(p[0][k]) for p in pics]).to(dev)
               for k in range(3)]
    kept = [p.clone() for p in stacked]
    tdb.launches = 0
    got = tdb.deblock_frames(
        *stacked,
        tuple(torch.stack([_t(p[1][k]) for p in pics]).to(dev)
              for k in range(11)),
        tuple(torch.stack([_t(p[2][k]) for p in pics]).to(dev)
              for k in range(6)),
        4, 10, 10, across.to(dev))
    assert tdb.launches == 1
    assert all(torch.equal(a, b) for a, b in zip(stacked, kept))
    for i, (planes, maps, sl, _) in enumerate(pics):
        want = _deblock_torch(planes, maps, sl, 4, 10, bool(across[i]))
        assert all(torch.equal(g[i].cpu(), wnt) for g, wnt in zip(got, want))


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
