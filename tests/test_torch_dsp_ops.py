"""The port's DSP op library (turingcodec_tpu_torch.ops: metrics, quant,
forward transform, all-modes intra, all-phases interpolation) against the
JAX package's functions and the numpy oracles, on the CPU: the wrappers
take the kernels' plain versions for CPU tensors, and both are held here.
Inputs come from numpy with a seed; every value is an integer, so equality
is exact (tolerance 0)."""
import numpy as np
import pytest
import torch

import turingcodec_tpu.ops.inter as jinter
import turingcodec_tpu.ops.intra as jintra
import turingcodec_tpu.ops.metrics as jmetrics
import turingcodec_tpu.ops.quant as jquant
import turingcodec_tpu.ops.transform as jtransform
from turingcodec_tpu_torch.ops import inter, intra, metrics, quant, transform


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("block", [4, 8])
@pytest.mark.parametrize("lead", [(6,), (3, 5)])
@pytest.mark.parametrize("bd", [8, 10])
def test_metrics_match_jax(block, lead, bd):
    rng = np.random.default_rng(block * 100 + len(lead) * 10 + bd)
    shape = lead + (2 * block, 4 * block)
    a = rng.integers(0, 1 << bd, shape).astype(np.int16)
    b = rng.integers(0, 1 << bd, shape).astype(np.int16)
    b[0] = (1 << bd) - 1 - a[0]                       # extreme differences
    for name in ("sad_batch", "ssd_batch"):
        got = getattr(metrics, name)(_t(a), _t(b))
        want = np.asarray(getattr(jmetrics, name)(a, b))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert metrics.sad_batch(_t(a), _t(b)).dtype == torch.int32
    assert metrics.ssd_batch(_t(a), _t(b)).dtype == torch.int64
    got = metrics.satd_batch(_t(a), _t(b), block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmetrics.satd_batch(a, b, block)))
    flat = a.reshape((-1,) + shape[-2:]), b.reshape((-1,) + shape[-2:])
    assert int(got.reshape(-1)[0]) == metrics.satd_np(flat[0][0],
                                                      flat[1][0], block)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("bd", [8, 10])
def test_quant_batch_matches_jax(log2, bd):
    n = 1 << log2
    rng = np.random.default_rng(log2 * 10 + bd)
    b = 48
    c = rng.integers(-32768, 32768, (b, n, n)).astype(np.int32)
    c[0] = 32767
    c[1] = -32768
    qp = rng.integers(0, 52 + 6 * (bd - 8), b).astype(np.int32)  # mixed
    q_shift = 29 - bd - log2 + qp // 6
    rnd = ((rng.integers(1, 4, b) << q_shift) // 6).astype(np.int32)
    got = quant.quant_batch(_t(c), _t(qp), bd, log2, _t(rnd))
    want = np.asarray(jquant.quant_batch(c, qp, bd, log2, rnd))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _residuals(rng, b, n, bd):
    hi = (1 << bd) - 1
    r = rng.integers(-hi, hi + 1, (b, n, n)).astype(np.int32)
    r[0], r[1] = hi, -hi                           # the HM range's ends
    r[2] = np.where(np.indices((n, n)).sum(0) % 2, hi, -hi)
    return r


FWD_CASES = [(log2, bd, False) for log2 in (2, 3, 4, 5) for bd in (8, 10)] \
    + [(2, 8, True), (2, 10, True), (5, 12, False)]


@pytest.mark.parametrize("log2,bd,dst", FWD_CASES)
def test_forward_transform_matches_jax(log2, bd, dst):
    n = 1 << log2
    rng = np.random.default_rng(log2 * 100 + bd + dst)
    res = _residuals(rng, 40, n, bd)
    want = np.asarray(jtransform.forward_transform_batch(res, bd, dst))
    before = transform.fwd_launches
    got = transform.forward_transform_batch(_t(res), bd, dst)
    assert transform.fwd_launches == before       # the CPU takes the plain
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        transform.forward_transform_batch_ref(_t(res), bd, dst).numpy(), want)
    for i in range(3):
        np.testing.assert_array_equal(
            want[i], transform.forward_transform_np(res[i], bd, dst))


def test_forward_transform_rejects_what_the_kernel_does_not_take():
    r = torch.zeros((2, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        transform.forward_transform_batch(r, 8, True)          # DST not 4x4
    with pytest.raises(ValueError):
        transform.forward_transform_batch(r, 13)
    with pytest.raises(TypeError):
        transform.forward_transform_batch(r.to(torch.int16))
    with pytest.raises(ValueError):
        transform.forward_transform_batch(torch.zeros((2, 8, 6),
                                                      dtype=torch.int32))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("bd", [8, 10])
def test_intra_all_modes_match_jax(n, bd):
    rng = np.random.default_rng(n + bd)
    b = 6
    rt = rng.integers(0, 1 << bd, (b, 2 * n + 1)).astype(np.int32)
    rl = rng.integers(0, 1 << bd, (b, 2 * n + 1)).astype(np.int32)
    co = rng.integers(0, 1 << bd, b).astype(np.int32)
    rt[0], rl[0], co[0] = (1 << bd) - 1, 0, (1 << bd) - 1   # extremes
    got = intra.intra_predict_all_modes(_t(rt), _t(rl), _t(co), n, bd)
    want = np.asarray(jintra.intra_predict_all_modes(rt, rl, co, n, bd))
    assert got.dtype == torch.int32 and got.shape == (b, 35, n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = intra.intra_predict_all_modes_np(rt[:2], rl[:2], co[:2], n, bd)
    np.testing.assert_array_equal(got.numpy()[:2], oracle)
    np.testing.assert_array_equal(
        oracle, jintra.intra_predict_all_modes_np(rt[:2], rl[:2], co[:2], n,
                                                  bd))


# the 1080p shapes, a warp over 4-8 windows (4x8, 8x4), the kernel's
# largest whole-window tiles (32x32) and its row bands (64x64), a width that
# splits warps across windows (12x20); 13 and 14 bits are as far as the
# full-pel phase's shift, 14 - bit depth, is defined
@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (8, 16), (16, 8), (4, 8),
                                 (8, 4), (32, 32), (64, 64), (12, 20)])
@pytest.mark.parametrize("bd", [8, 10, 13, 14])
def test_interp_all_phases_match_jax(w, h, bd):
    rng = np.random.default_rng(w * 10 + h + bd)
    b = 5
    win = rng.integers(0, 1 << bd, (b, h + 7, w + 7)).astype(np.int16)
    win[0] = (1 << bd) - 1
    win[1] = np.where(np.indices((h + 7, w + 7)).sum(0) % 2, (1 << bd) - 1,
                      0)                          # the largest filter swings
    want = np.asarray(jinter.interp_luma_all_phases(win, w, h, bd))
    before = inter.interp_launches
    got = inter.interp_luma_all_phases(_t(win), w, h, bd)
    assert inter.interp_launches == before
    assert got.dtype == torch.int32 and got.shape == (b, 4, 4, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        inter.interp_luma_all_phases_ref(_t(win), w, h, bd).numpy(), want)
    oracle = inter.interp_luma_all_phases_np(win[:2], w, h, bd)
    np.testing.assert_array_equal(got.numpy()[:2], oracle)
    np.testing.assert_array_equal(
        oracle, jinter.interp_luma_all_phases_np(win[:2], w, h, bd))


def test_interp_all_phases_rejects_what_the_kernel_does_not_take():
    win = torch.zeros((2, 15, 15), dtype=torch.int16)
    with pytest.raises(ValueError):
        inter.interp_luma_all_phases(win, 8, 16)
    with pytest.raises(TypeError):
        inter.interp_luma_all_phases(win.to(torch.int32), 8, 8)
    for bd in (7, 15, 16):     # 14 - bd < 0 above 14: JAX's is undefined
        with pytest.raises(ValueError):
            inter.interp_luma_all_phases(win, 8, 8, bd)
        with pytest.raises(ValueError):
            inter.interp_luma_all_phases_ref(win, 8, 8, bd)
