"""The port's GOP-batched stages (turingcodec_tpu_torch/parallel/,
encode/device_analysis.py's *_frames_batched) against the JAX package's
sharded ones on the virtual CPU mesh (tests/conftest.py) and against the
port's own per-frame calls: exact integers (tolerance 0), with the one
stated exception of analysis_step's distortion, which the JAX program sums
in float32 (held against it only where float32 is exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import turingcodec_tpu.encode.device_analysis as jda
import turingcodec_tpu_torch.encode.device_analysis as tda
from turingcodec_tpu.parallel import gop_decode as jgop
from turingcodec_tpu.parallel import mesh as jmesh
from turingcodec_tpu_torch.ops.deblock import deblock_device
from turingcodec_tpu_torch.ops.inter import mc_block_grid
from turingcodec_tpu_torch.ops.sao import _sao_plane
from turingcodec_tpu_torch.ops.transform import (dequant_inverse_transform,
                                                 forward_transform_np)
from turingcodec_tpu_torch.parallel import gop_decode as tgop
from turingcodec_tpu_torch.parallel import mesh as tmesh
from turingcodec_tpu_torch.tools.signature import STREAM


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_make_mesh_is_a_grid_of_one_device(monkeypatch):
    m = tmesh.make_mesh(4, 2, "cpu")
    assert m.shape == {"frame": 4, "row": 2} and m.device == torch.device(
        "cpu")
    assert tmesh.make_mesh(2, 2, ["cpu"]).devices.shape == (2, 2)
    with pytest.raises(ValueError, match="one torch device"):
        tmesh.make_mesh(1, 2, ["cpu", "meta"])
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, 1, ["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(1, 1)


def _analysis_inputs(case):
    rng = np.random.default_rng(0)
    shape = (4, 2, 2, 32, 32)
    ctus = rng.integers(0, 256, shape).astype(np.int32)
    if case == "float32_exact":      # small residuals: small coefficients
        preds = np.clip(ctus + rng.integers(-3, 4, shape), 0, 255)
    else:                            # the JAX test's inputs
        preds = rng.integers(0, 256, shape)
    return ctus, preds.astype(np.int32)


def _exact_rate_dist(ctus, preds, qp=26):
    """numpy oracle: the forward transform, HM quantisation at rounding
    171 << 6, then the rate proxy and the int64 distortion."""
    from turingcodec_tpu_torch.hevc.tables import QUANT_SCALES
    res = (ctus - preds).reshape(-1, 32, 32)
    c = np.stack([forward_transform_np(r, 8) for r in res]).astype(np.int64)
    shift = 29 - 8 - 5 + qp // 6
    lv = np.minimum((np.abs(c) * int(QUANT_SCALES[qp % 6]) + (171 << 6))
                    >> shift, 32767)
    rate = (lv != 0).sum((1, 2)) + lv.sum((1, 2))
    dist = np.where(lv == 0, c * c, 0).sum((1, 2))
    return rate.reshape(ctus.shape[:3]), dist.reshape(ctus.shape[:3])


@pytest.mark.parametrize("case,qp", [("float32_exact", 26),
                                     ("float32_inexact", 51)])
def test_analysis_step_matches_jax(case, qp):
    """At QP 51 the random residuals' coefficients mostly quantise to 0,
    and their squares' sums pass 2^24."""
    ctus, preds = _analysis_inputs(case)
    rate, dist, tr, td = tmesh.sharded_analysis(tmesh.make_mesh(4, 2, "cpu"))(
        torch.from_numpy(ctus), torch.from_numpy(preds), qp)
    jr, jd, jtr, jtd = jmesh.sharded_analysis(jmesh.make_mesh(4, 2))(
        jnp.asarray(ctus), jnp.asarray(preds), jnp.asarray(qp, jnp.int32))
    want_rate, want_dist = _exact_rate_dist(ctus, preds, qp)
    assert rate.dtype == torch.int32 and dist.dtype == torch.int64
    np.testing.assert_array_equal(rate.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(rate.numpy(), want_rate)
    np.testing.assert_array_equal(dist.numpy(), want_dist)
    assert int(tr) == int(jtr) == int(want_rate.sum())
    assert int(td) == int(want_dist.sum())
    # JAX's float32 sum is exact where every partial sum stays below 2^24
    exact = want_dist < (1 << 24)
    assert exact.all() == (case == "float32_exact")
    np.testing.assert_array_equal(dist.numpy()[exact], np.asarray(jd)[exact])
    if case == "float32_exact":
        assert int(td) == int(jtd)


def test_sharded_analysis_checks_the_grid():
    fn = tmesh.sharded_analysis(tmesh.make_mesh(2, 2, "cpu"))
    x = torch.zeros((2, 1, 1, 32, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="mesh"):
        fn(x, x, 30)


def _mc_inputs(bs, taps, f=4, r=2, h=40, w=56, b=96, seed=3):
    rng = np.random.default_rng(seed)
    phases = 4 if taps == 8 else 8
    refs = rng.integers(0, 256, (f, r, h, w)).astype(np.int16)
    sel = rng.integers(0, r + 2, (f, b)).astype(np.int32)   # some past R
    xi = rng.integers(-20, w + 12, (f, b)).astype(np.int32)
    yi = rng.integers(-20, h + 12, (f, b)).astype(np.int32)
    xf = rng.integers(0, phases, (f, b)).astype(np.int32)
    yf = rng.integers(0, phases, (f, b)).astype(np.int32)
    return refs, sel, xi, yi, xf, yf


@pytest.mark.parametrize("bs,taps", [(4, 8), (2, 4)])
def test_gop_mc_matches_jax_and_per_frame_calls(bs, taps):
    args = _mc_inputs(bs, taps)
    got = tgop.sharded_gop_mc(tmesh.make_mesh(4, 1, "cpu"), bs, taps, 8)(
        *map(torch.from_numpy, args))
    want = jgop.sharded_gop_mc(jmesh.make_mesh(4, 1), bs, taps, 8)(
        *map(jnp.asarray, args))
    assert got.shape == (4, 96, bs, bs) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    refs, sel = args[:2]
    for i in range(4):
        per = [torch.from_numpy(a[i][None]) for a in args[1:]]
        one = mc_block_grid([[torch.from_numpy(refs[i])]], *per, bs, taps,
                            8)[0, 0]
        assert torch.equal(got[i], one)


def test_gop_mc_raises_beyond_one_launchs_planes():
    args = _mc_inputs(4, 8, f=33, r=2, b=4)   # 66 reference planes
    with pytest.raises(ValueError, match="planes"):
        tgop.gop_mc(*map(torch.from_numpy, args))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_gop_residual_matches_jax_and_per_frame_calls(log2):
    n = 1 << log2
    rng = np.random.default_rng(log2)
    blocks = rng.integers(-64, 65, (2, 6, n, n))
    blocks[0, 0] = rng.integers(-32768, 32768, (n, n))     # saturating
    blocks[1, 1] = 0
    qps = rng.integers(0, 52, (2, 6)).astype(np.int32)
    blocks = blocks.astype(np.int32)
    got = tgop.sharded_gop_residual(tmesh.make_mesh(2, 1, "cpu"), 8, log2)(
        torch.from_numpy(blocks), torch.from_numpy(qps))
    want = jgop.sharded_gop_residual(jmesh.make_mesh(2, 1), 8, log2)(
        jnp.asarray(blocks), jnp.asarray(qps))
    assert got.dtype == torch.int32 and got.shape == blocks.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.abs().max() > 255      # beyond any sample range: unclipped
    for i in range(2):
        assert torch.equal(got[i], dequant_inverse_transform(
            torch.from_numpy(blocks[i]), torch.from_numpy(qps[i]), 8, log2,
            0))


@pytest.fixture(scope="module")
def pictures():
    """vfy_sweep's pictures as the host decoder filters them."""
    with open(STREAM, "rb") as f:
        return tgop.capture_pictures(f.read())


@pytest.mark.parametrize("across", ["true", "mixed"])
def test_gop_deblock_matches_jax_and_per_frame_calls(pictures, across):
    caps = pictures[1:5]
    args, (ctb_log2, bd_y, bd_c) = tgop.deblock_inputs(caps, "cpu")
    if across == "mixed":      # the per-frame flag as a batched tensor
        args = args[:5] + (torch.tensor([True, False, False, True]),)
    got = tgop.sharded_gop_deblock(tmesh.make_mesh(4, 1, "cpu"), ctb_log2,
                                   bd_y, bd_c)(*args)
    jargs = [jnp.asarray(_np(a)) for a in args[:3]] + [
        tuple(jnp.asarray(_np(m)) for m in args[3]),
        tuple(jnp.asarray(_np(v)) for v in args[4]), jnp.asarray(_np(args[5]))]
    want = jgop.sharded_gop_deblock(jmesh.make_mesh(4, 1), ctb_log2, bd_y,
                                    bd_c)(*jargs)
    for k in range(3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(), np.stack(
            [p["post"][k] for p in caps]))
    for i in range(4):
        one = deblock_device(*(a[i] for a in args[:3]),
                             tuple(m[i] for m in args[3]),
                             tuple(v[i] for v in args[4]), ctb_log2, bd_y,
                             bd_c, bool(args[5][i]))
        assert all(torch.equal(o, g[i]) for o, g in zip(one, got))


@pytest.mark.parametrize("c_idx", [0, 1, 2])
def test_gop_sao_matches_jax_and_per_frame_calls(pictures, c_idx):
    caps = [p for p in pictures if p["sao"] is not None][:4]
    assert len(caps) == 4
    stacked, (ctb, bd, sub), per = tgop.sao_inputs(caps, c_idx, "cpu")
    got = tgop.sharded_gop_sao(tmesh.make_mesh(4, 1, "cpu"), ctb, bd, sub)(
        *stacked)
    want = jgop.sharded_gop_sao(jmesh.make_mesh(4, 1), ctb, bd, sub)(
        *[jnp.asarray(_np(a)) for a in stacked])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.stack(
        [p["sao"][c_idx] for p in caps]))
    for i in range(4):
        assert torch.equal(_sao_plane(*per[i]), got[i])


def _pairs(n=2, h=72, w=104, seed=5):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + 24, w + 24)).astype(np.int16)
    origs = np.stack([base[i + 3:i + 3 + h, 2 * i + 5:2 * i + 5 + w]
                      for i in range(n)])
    refs = np.stack([base[i:i + h, 2 * i:2 * i + w] for i in range(n)])
    refs[:, 10:30, 20:50] = rng.randint(0, 256, (n, 20, 30))
    return origs, refs


def test_frames_batched_match_jax_sharded(monkeypatch):
    """Both batched functions against the JAX package's frame-sharded
    pair (its dense sweep as the XLA scan: the Pallas kernel's parity is
    tests/test_torch_dense_me.py's), and against the per-pair calls."""
    monkeypatch.setenv("TC_DENSE_PALLAS", "0")
    origs, refs = _pairs()
    mesh = jmesh.make_mesh(2, 1)
    tm = tmesh.make_mesh(2, 1, "cpu")
    want = jda.analysis_frames_sharded(mesh, origs, refs)
    want_seed = jda.seed_fields_frames_sharded(mesh, origs, refs)
    got = tda.analysis_frames_sharded(tm, origs, refs, 8)
    got_seed = tda.seed_fields_frames_sharded(tm, origs, refs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_seed, want_seed):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], got_seed[0])
    for i in range(2):
        one = tda.analysis_device(origs[i], refs[i], "cpu", bit_depth=8)
        for g, w in zip(got[:3], one[:3]):
            np.testing.assert_array_equal(g[i], w)


def test_analysis_frames_batched_sweeps_once_per_pair(monkeypatch):
    calls = []
    sweep = tda.dense_me_sweep
    monkeypatch.setattr(tda, "dense_me_sweep",
                        lambda *a, **k: calls.append(k) or sweep(*a, **k))
    origs, refs = _pairs(n=3)
    tda.analysis_frames_batched(origs, refs, "cpu", bit_depth=8)
    assert calls == [{"bit_depth": 8}] * 3
