"""The port's dense-ME sweep (turingcodec_tpu_torch.ops.dense_me) against
the JAX package's Pallas kernel in interpret mode, its _dense_stage and a
brute-force loop: exact integers (tolerance 0).

The Pallas kernel runs in interpret mode with jit disabled: compiling its
289-step unrolled body for the CPU takes minutes, evaluating it op by op
about ten seconds. All cases go through it as one batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import turingcodec_tpu.encode.device_analysis as jda
import turingcodec_tpu_torch.encode.device_analysis as tda
from turingcodec_tpu.ops.pallas_kernels import dense_me_argmin as jax_dense
from turingcodec_tpu_torch.ops import dense_me
from turingcodec_tpu_torch.ops.dense_me import (dense_inputs,
                                                dense_me_argmin,
                                                dense_me_argmin_ref,
                                                dense_me_sweep)


def _planted(seed=7, b=7, hi=256):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, hi, (b, 16, 16)).astype(np.int32)
    pat = rng.integers(0, hi, (b, 32, 32)).astype(np.int32)
    # plant exact matches at known offsets to exercise tie-breaks
    pat[0, 8:24, 8:24] = cur[0]          # offset (0, 0)
    pat[1, 0:16, 0:16] = cur[1]          # offset (-8, -8)
    pat[2, 16:32, 13:29] = cur[2]        # offset (+5, +8)
    return cur, pat


def _all_ties(b=7):
    # every window has SAD 0: only the |ox| + |oy| penalty separates them
    return (np.full((b, 16, 16), 77, np.int32),
            np.full((b, 32, 32), 77, np.int32))


def _straddle_14bit(b=7):
    """14-bit blocks whose costs straddle 2^23: the winner at (0, 0) costs
    just below it, most other offsets just above, where a 32-bit key
    (cost << 9) | k wraps to small values and would win."""
    rng = np.random.default_rng(5)
    cur = np.full((b, 16, 16), 16383, np.int32)
    pat = np.full((b, 32, 32), 16383 - 8400, np.int32)
    pat[:, 8:24, 8:24] = 16383 - 8000
    pat += rng.integers(-3, 1, pat.shape).astype(np.int32)
    return cur, pat


def _brute(cur, pat):
    want = np.zeros((cur.shape[0], 3), np.int64)
    for i in range(cur.shape[0]):
        best = None
        for oy in range(17):
            for ox in range(17):
                sad = np.abs(cur[i].astype(np.int64)
                             - pat[i, oy:oy + 16, ox:ox + 16]).sum()
                cost = (sad << 2) + abs(ox - 8) + abs(oy - 8)
                if best is None or cost < best:
                    best = cost
                    want[i] = (ox - 8, oy - 8, sad)
    return want


CASES = {"planted": _planted, "all_ties": _all_ties,
         "planted_10bit": lambda: _planted(seed=3, hi=1024),
         "planted_14bit": lambda: _planted(seed=9, hi=1 << 14),
         "straddle_14bit": _straddle_14bit}
BITS = {"planted_10bit": 10, "planted_14bit": 14, "straddle_14bit": 14}


@pytest.fixture(scope="module")
def pallas_results():
    """{case: (B, 3)} from one interpret-mode run over all cases."""
    names = sorted(CASES)
    inputs = [CASES[c]() for c in names]
    cur = np.concatenate([i[0] for i in inputs])
    pat = np.concatenate([i[1] for i in inputs])
    with jax.disable_jit():
        out = np.asarray(jax_dense(cur, pat, interpret=True))
    split = np.cumsum([i[0].shape[0] for i in inputs])[:-1]
    return dict(zip(names, np.split(out, split)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_me_matches_pallas_interpret(case, pallas_results):
    cur, pat = CASES[case]()
    got = dense_me_argmin(torch.from_numpy(cur), torch.from_numpy(pat),
                          bit_depth=BITS.get(case, 8))
    assert got.dtype == torch.int32 and got.shape == (cur.shape[0], 3)
    np.testing.assert_array_equal(got.numpy(), pallas_results[case])
    if case == "straddle_14bit":
        # the winner costs just below 2^23; the same keys taken modulo 2^32,
        # as a 32-bit (cost << 9) | k holds them, have their min elsewhere
        assert (got[:, :2] == 0).all() and (got[:, 2] << 2 < 1 << 23).all()
        k = np.arange(289)
        sad = np.stack([np.abs(cur - pat[:, oy:oy + 16, ox:ox + 16])
                        .sum((-2, -1)) for oy in range(17)
                        for ox in range(17)], 1).astype(np.int64)
        pen = np.abs(k % 17 - 8) + np.abs(k // 17 - 8)
        key32 = ((((sad << 2) + pen) << 9) | k) & 0xffffffff
        assert (key32.argmin(1) != 8 * 17 + 8).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_me_ref_matches_brute_force(case):
    cur, pat = CASES[case]()
    got = dense_me_argmin_ref(torch.from_numpy(cur), torch.from_numpy(pat))
    np.testing.assert_array_equal(got.numpy(), _brute(cur, pat))
    if case == "planted":
        assert tuple(got[0].tolist()) == (0, 0, 0)
        assert tuple(got[1].tolist()) == (-8, -8, 0)
        assert tuple(got[2].tolist()) == (5, 8, 0)
    if case == "all_ties":
        assert (got == 0).all()


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    cur, pat = _planted()
    before = dense_me.launches
    dense_me_argmin(torch.from_numpy(cur), torch.from_numpy(pat), bit_depth=8)
    assert dense_me.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    cur, pat = (torch.from_numpy(a) for a in _planted())
    if bad == "dtype":
        cur = cur.to(torch.int64)
    elif bad == "shape":
        pat = pat[:, :31, :31].contiguous()
    else:
        cur = cur.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        dense_me_argmin(cur, pat, bit_depth=8)


@pytest.mark.parametrize("bd", [0, 17])
def test_wrappers_reject_bit_depths_the_kernel_cannot_hold(bd):
    """The float SADs are exact up to 16 bits, and the encoder admits no
    more: the wrappers refuse other depths before any launch."""
    cur, pat = (torch.from_numpy(a) for a in _planted())
    with pytest.raises(ValueError, match="bit depth"):
        dense_me_argmin(cur, pat, bit_depth=bd)
    orig, ref, seeds, w, h, wb, hb = _sweep_inputs("odd_8bit")
    with pytest.raises(ValueError, match="bit depth"):
        dense_me_sweep(*(torch.from_numpy(a) for a in (orig, ref, seeds)),
                       w, h, wb, hb, bit_depth=bd)


# frames whose sizes are not multiples of 16 (1080 = 67 * 16 + 8), with
# seeds to +-36, the lowres pre-ME's reach, at the grid's corners
SWEEPS = {"odd_8bit": (40, 57, 8, 1), "odd_10bit": (35, 70, 10, 2),
          "one_block": (9, 13, 8, 3), "odd_14bit": (33, 50, 14, 4)}


def _sweep_inputs(name):
    h, w, bd, seed = SWEEPS[name]
    rng = np.random.default_rng(seed)
    orig = rng.integers(0, 1 << bd, (h, w)).astype(np.int16)
    ref = np.roll(orig, (3, -5), (0, 1)).astype(np.int16)
    ref[::5] = rng.integers(0, 1 << bd, (len(ref[::5]), w))
    wb, hb = tda.block_dims(w, h)
    seeds = rng.integers(-36, 37, (hb, wb, 2)).astype(np.int32)
    seeds[0, 0], seeds[-1, -1] = (-36, -36), (36, 36)
    seeds[0, -1], seeds[-1, 0] = (36, -36), (-36, 36)
    return orig, ref, seeds, w, h, wb, hb


def _brute_sweep(orig, ref, seeds, w, h, wb, hb):
    """The kernel's addressing in numpy: every coordinate clamped into the
    unpadded planes, then the brute-force scan per block."""
    by, bx = np.divmod(np.arange(hb * wb), wb)
    a16, a32 = np.arange(16), np.arange(32)
    sy = np.minimum(16 * by[:, None] + a16, h - 1)
    sx = np.minimum(16 * bx[:, None] + a16, w - 1)
    s = seeds.reshape(-1, 2)
    wy = np.clip(16 * by[:, None] + s[:, 1:2] - 8 + a32, 0, h - 1)
    wx = np.clip(16 * bx[:, None] + s[:, 0:1] - 8 + a32, 0, w - 1)
    cur = orig[sy[:, :, None], sx[:, None, :]].astype(np.int32)
    pat = ref[wy[:, :, None], wx[:, None, :]].astype(np.int32)
    return _brute(cur, pat)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_dense_me_sweep_matches_jax_dense_stage(name, monkeypatch):
    """The fused entry point's plain version (dense_me_argmin_ref over
    dense_inputs) against the JAX package's _dense_stage (the scan, not the
    Pallas kernel) and the clamped brute force, on int16 and int32
    planes; the port's _dense_stage adds the seeds as the JAX one does."""
    monkeypatch.setenv("TC_DENSE_PALLAS", "0")
    orig, ref, seeds, w, h, wb, hb = _sweep_inputs(name)
    mv, sad = jda._dense_stage(jnp.asarray(orig), jnp.asarray(ref),
                               jnp.asarray(seeds), w, h, wb, hb)
    want = np.concatenate([np.asarray(mv).reshape(-1, 2) - seeds.reshape(
        -1, 2), np.asarray(sad).reshape(-1, 1)], 1)
    np.testing.assert_array_equal(_brute_sweep(orig, ref, seeds, w, h, wb,
                                               hb), want)
    for dtype in (torch.int16, torch.int32):
        o, r = (torch.from_numpy(a).to(dtype) for a in (orig, ref))
        s = torch.from_numpy(seeds)
        got = dense_me_sweep(o, r, s, w, h, wb, hb, bit_depth=SWEEPS[name][2])
        assert got.dtype == torch.int32 and got.shape == (hb * wb, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            dense_me_argmin_ref(*dense_inputs(o, r, s, w, h, wb, hb)).numpy(),
            want)
    tmv, tsad = tda._dense_stage(o, r, s, w, h, wb, hb, bit_depth=SWEEPS[name][2])
    np.testing.assert_array_equal(tmv.numpy(), np.asarray(mv))
    np.testing.assert_array_equal(tsad.numpy(), np.asarray(sad))


def test_sweep_off_the_cpu_launches_or_raises(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: the
    sweep goes to the kernel, which needs a CUDA tensor, and never
    materialises the windows."""
    orig, ref, seeds, w, h, wb, hb = _sweep_inputs("odd_8bit")
    meta = [torch.from_numpy(a).to("meta") for a in (orig, ref, seeds)]

    def no_windows(*a):
        raise AssertionError("dense_inputs called off the CPU")

    monkeypatch.setattr(dense_me, "dense_inputs", no_windows)
    before = dense_me.launches
    with pytest.raises(ValueError, match="unsupported device"):
        dense_me_sweep(*meta, w, h, wb, hb, bit_depth=8)
    assert dense_me.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "seeds", "grid",
                                 "contiguous"])
def test_sweep_rejects_bad_inputs(bad):
    orig, ref, seeds, w, h, wb, hb = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _sweep_inputs("odd_8bit"))
    if bad == "dtype":
        orig, ref = orig.long(), ref.long()
    elif bad == "mixed":
        ref = ref.int()
    elif bad == "seeds":
        seeds = seeds[:, :-1].contiguous()
    elif bad == "grid":
        seeds, wb = seeds[:, :-1].contiguous(), wb - 1
    else:
        orig = orig.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        dense_me_sweep(orig, ref, seeds, w, h, wb, hb, bit_depth=8)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_dense_me_surface_matches_jax_and_brute_force(name):
    """want_surf: the fused sweep's plain version returns the winners
    unchanged and every block's 289 SADs at k = oy * 17 + ox, equal to the
    JAX package's want_surf surface and to a brute force over the clamped
    windows."""
    orig, ref, seeds, w, h, wb, hb = _sweep_inputs(name)
    _mv, _sad, surf = jda._dense_stage(jnp.asarray(orig), jnp.asarray(ref),
                                       jnp.asarray(seeds), w, h, wb, hb,
                                       want_surf=True)
    by, bx = np.divmod(np.arange(hb * wb), wb)
    a16, a32 = np.arange(16), np.arange(32)
    sy = np.minimum(16 * by[:, None] + a16, h - 1)
    sx = np.minimum(16 * bx[:, None] + a16, w - 1)
    s = seeds.reshape(-1, 2)
    wy = np.clip(16 * by[:, None] + s[:, 1:2] - 8 + a32, 0, h - 1)
    wx = np.clip(16 * bx[:, None] + s[:, 0:1] - 8 + a32, 0, w - 1)
    cur = orig[sy[:, :, None], sx[:, None, :]].astype(np.int64)
    pat = ref[wy[:, :, None], wx[:, None, :]].astype(np.int64)
    brute = np.stack([np.abs(cur - pat[:, oy:oy + 16, ox:ox + 16]).sum((1, 2))
                      for oy in range(17) for ox in range(17)], 1)
    np.testing.assert_array_equal(np.asarray(surf), brute)
    args = [torch.from_numpy(a) for a in (orig, ref, seeds)]
    bd = SWEEPS[name][2]
    res, got = dense_me_sweep(*args, w, h, wb, hb, True, bit_depth=bd)
    assert got.dtype == torch.int32 and got.shape == (hb * wb, 289)
    np.testing.assert_array_equal(got.numpy(), brute)
    assert torch.equal(res, dense_me_sweep(*args, w, h, wb, hb, bit_depth=bd))
    cb, pt = dense_inputs(*args, w, h, wb, hb)
    res2, got2 = dense_me_argmin_ref(cb, pt, want_surf=True)
    assert torch.equal(res2, res) and torch.equal(got2, got)
