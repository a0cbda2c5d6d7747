"""The port's dense-ME sweep (turingcodec_tpu_torch.ops.dense_me) against
the JAX package's Pallas kernel in interpret mode and a brute-force loop:
exact integers (tolerance 0).

The Pallas kernel runs in interpret mode with jit disabled: compiling its
289-step unrolled body for the CPU takes minutes, evaluating it op by op
about ten seconds. All cases go through it as one batch."""
import jax
import numpy as np
import pytest
import torch

from turingcodec_tpu.ops.pallas_kernels import dense_me_argmin as jax_dense
from turingcodec_tpu_torch.ops import dense_me
from turingcodec_tpu_torch.ops.dense_me import (dense_me_argmin,
                                                dense_me_argmin_ref)


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
         "planted_10bit": lambda: _planted(seed=3, hi=1024)}


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
    got = dense_me_argmin(torch.from_numpy(cur), torch.from_numpy(pat))
    assert got.dtype == torch.int32 and got.shape == (cur.shape[0], 3)
    np.testing.assert_array_equal(got.numpy(), pallas_results[case])


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
    dense_me_argmin(torch.from_numpy(cur), torch.from_numpy(pat))
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
        dense_me_argmin(cur, pat)
