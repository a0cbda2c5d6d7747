"""The port's decoder device ops against the JAX package on the CPU: the
same inputs, made from a numpy seed, through the JAX function and its
port. Exact integers (tolerance 0): HEVC reconstruction is integer
arithmetic.

Covers ops/inter.mc_block_grid, ops/quant.dequant_batch,
ops/transform.inverse_transform_batch and dequant_inverse_transform (the
CUDA kernels' wrappers take their plain versions for CPU tensors),
device_recon._combine_uni_bi and ops/inter._scatter_blocks (the
combine, which ops/inter now holds, and the scatter of mc_picture's plain
version) and ops/transform._block_grid_add (the add and clip of the
residual kernel's plain version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import turingcodec_tpu.decode.device_pipeline as jpipe
import turingcodec_tpu.decode.device_recon as jrecon
import turingcodec_tpu.ops.inter as jinter
import turingcodec_tpu.ops.quant as jquant
import turingcodec_tpu.ops.transform as jtransform
import turingcodec_tpu_torch.decode.device_recon as trecon
import turingcodec_tpu_torch.ops.inter as tinter
import turingcodec_tpu_torch.ops.quant as tquant
import turingcodec_tpu_torch.ops.transform as ttransform

T = torch.from_numpy


def _mc_inputs(bd, phases, seed):
    rng = np.random.default_rng(seed)
    h, w, b = 40, 56, 300
    refs = rng.integers(0, 1 << bd, (3, h, w)).astype(np.int16)
    k = np.arange(b)
    # windows past every edge: the gather clamps (spec edge extension)
    blocks = [rng.integers(0, 3, b), rng.integers(-16, w + 8, b),
              rng.integers(-16, h + 8, b), k % phases, k // phases % phases]
    return refs, [a.astype(np.int32) for a in blocks]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_mc_block_grid_matches_jax(bd, plane):
    """One call of two lists: luma as one component, Cb and Cr as two, each
    (list, component) held against its own JAX call. The lists' reference
    counts differ."""
    bs, taps, phases = (4, 8, 4) if plane == "luma" else (2, 4, 8)
    refs, blocks = _mc_inputs(bd, phases, seed=bd + taps)
    refs1, blocks1 = _mc_inputs(bd, phases, seed=bd + taps + 1)
    refs1, blocks1[0] = refs1[:2], blocks1[0] % 2
    lists = [[refs], [refs1]]
    if plane == "chroma":
        lists = [[refs, refs[::-1] ^ 1], [refs1, refs1 ^ 3]]
    per_list = [blocks, blocks1]
    want = [[np.asarray(jinter.mc_block_grid(
        jnp.asarray(r), *[jnp.asarray(a) for a in per_list[lx]], bs, taps,
        bd)) for r in lst] for lx, lst in enumerate(lists)]
    before = tinter.launches
    # a component is a sequence of (H, W) planes: a stack or a list
    planes = [[T(c) if i == 0 else list(T(c)) for i, c in enumerate(lst)]
              for lst in lists]
    got = tinter.mc_block_grid(planes, *[T(np.stack(a)) for a in
                                         zip(*per_list)], bs, taps, bd)
    assert tinter.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.int32
    assert got.shape == (2, len(lists[0]), 300, bs, bs)
    for g_l, w_l in zip(got, want):
        for g, w in zip(g_l, w_l):
            np.testing.assert_array_equal(g.numpy(), w)


def _levels(log2, bd, seed):
    rng = np.random.default_rng(seed)
    n, b = 1 << log2, 96
    lv = rng.integers(-32768, 32768, (b, n, n))
    lv[::2] = rng.integers(-300, 301, (b // 2, n, n))
    lv[0, 0, :2] = (-32768, 32767)
    qp = np.arange(b) % (52 + 6 * (bd - 8))
    return lv.astype(np.int32), qp.astype(np.int32)


CASES = [(bd, log2) for bd in (8, 10) for log2 in (2, 3, 4, 5)]


@pytest.mark.parametrize("bd,log2", CASES)
def test_dequant_batch_matches_jax(bd, log2):
    lv, qp = _levels(log2, bd, seed=log2)
    want = np.asarray(jquant.dequant_batch(jnp.asarray(lv), jnp.asarray(qp),
                                           bd, log2))
    got = tquant.dequant_batch(T(lv), T(qp), bd, log2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the numpy oracle agrees per block, and with its JAX twin
    for i in (0, 1, 50):
        np.testing.assert_array_equal(
            tquant.dequant_np(lv[i], int(qp[i]), bd, log2), want[i])
        np.testing.assert_array_equal(
            tquant.dequant_np(lv[i], int(qp[i]), bd, log2),
            jquant.dequant_np(lv[i], int(qp[i]), bd, log2))


@pytest.mark.parametrize("bd,log2", CASES)
def test_inverse_transform_batch_matches_jax(bd, log2):
    rng = np.random.default_rng(100 + log2)
    n = 1 << log2
    d = rng.integers(-32768, 32768, (64, n, n)).astype(np.int32)
    d[::2] = rng.integers(-500, 501, (32, n, n))
    dst = [False, True] if log2 == 2 else [False]
    for use_dst in dst:
        want = np.asarray(jtransform.inverse_transform_batch(
            jnp.asarray(d), bd, use_dst))
        got = ttransform.inverse_transform_batch(T(d), bd, use_dst)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd,log2", CASES)
def test_dequant_inverse_transform_matches_composition(bd, log2):
    """The kernel's wrapper against the JAX composition it replaces:
    mode 0 dequant + inverse DCT, mode 1 the transform-skip arm of
    device_pipeline._residuals_device."""
    lv, qp = _levels(log2, bd, seed=200 + log2)
    d = jquant.dequant_batch(jnp.asarray(lv), jnp.asarray(qp), bd, log2)
    bds2 = 20 - bd
    want = {0: np.asarray(jtransform.inverse_transform_batch(d, bd, False)),
            1: np.asarray(jnp.clip(((d << 7) + (1 << (bds2 - 1))) >> bds2,
                                   -32768, 32767))}
    before = ttransform.launches
    for mode in (0, 1):
        got = ttransform.dequant_inverse_transform(T(lv), T(qp), bd, log2,
                                                   mode)
        np.testing.assert_array_equal(got.numpy(), want[mode])
        np.testing.assert_array_equal(
            ttransform.dequant_inverse_transform_ref(T(lv), T(qp), bd, log2,
                                                     mode).numpy(),
            want[mode])
    assert ttransform.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "mode"])
def test_dequant_inverse_transform_rejects_bad_inputs(bad):
    lv, qp = (T(a) for a in _levels(3, 8, seed=1))
    mode = 0
    if bad == "dtype":
        lv = lv.to(torch.int64)
    elif bad == "shape":
        lv = lv[:, :4, :4].contiguous()
    elif bad == "contiguous":
        lv = lv.transpose(1, 2)
    else:
        mode = 2
    with pytest.raises((TypeError, ValueError)):
        ttransform.dequant_inverse_transform(lv, qp, 8, 3, mode)


@pytest.mark.parametrize("bad", ["dtype", "shape", "taps", "sizes",
                                 "components", "groups", "planes", "lists"])
def test_mc_block_grid_rejects_bad_inputs(bad):
    refs, blocks = _mc_inputs(8, 4, seed=3)
    refs, blocks, taps = T(refs), [T(a)[None] for a in blocks], 8
    planes = [[refs]]
    if bad == "dtype":
        planes = [[refs.to(torch.int32)]]
    elif bad == "shape":
        blocks[2] = blocks[2][:, :10]
    elif bad == "taps":
        taps = 6
    elif bad == "sizes":       # planes of two sizes
        planes = [[[refs[0], refs[1, :-2].contiguous()]]]
    elif bad == "components":  # lists with different component counts
        planes = [[refs], [refs, refs]]
        blocks = [a.expand(2, -1).contiguous() for a in blocks]
    elif bad == "groups":      # more (list, component) groups than a launch
        planes = [[refs] * 5]
    elif bad == "planes":      # more planes than a launch takes
        planes = [[list(refs) * 11] * 2]
    else:                      # motion rows for one list, planes for two
        planes = [[refs], [refs]]
    with pytest.raises((TypeError, ValueError)):
        tinter.mc_block_grid(planes, *blocks, 4, taps, 8)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lists", ["both", "list0", "list1"])
def test_combine_uni_bi_matches_jax(bd, lists):
    """With both lists in use, and with one list that no block uses, which
    _predict skips and hands over as None."""
    rng = np.random.default_rng(bd)
    b = 200
    p0, p1 = (rng.integers(-(1 << 13), 1 << 14, (b, 4, 4)).astype(np.int32)
              for _ in range(2))
    on0, on1 = rng.integers(0, 2, b) > 0, rng.integers(0, 2, b) > 0
    on1[~on0] = True  # every block uses at least one list
    if lists != "both":
        on0[:] = lists == "list0"
        on1[:] = lists == "list1"
    want = np.asarray(jrecon._combine_uni_bi(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(on0),
        jnp.asarray(on1), bd))
    t0 = None if lists == "list1" else T(p0)
    t1 = None if lists == "list0" else T(p1)
    got = trecon._combine_uni_bi(t0, t1, T(on0), T(on1), bd)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bs", [4, 2])
def test_scatter_blocks_matches_jax(bs):
    rng = np.random.default_rng(bs)
    h, w = 8 * bs, 12 * bs
    plane = rng.integers(0, 256, (h, w)).astype(np.int16)
    cells = rng.permutation((h // bs) * (w // bs))[:40]
    by, bx = (cells // (w // bs)).astype(np.int32), \
        (cells % (w // bs)).astype(np.int32)
    blocks = rng.integers(0, 1024, (40, bs, bs)).astype(np.int32)
    want = np.asarray(jpipe._scatter_blocks(
        jnp.asarray(plane), jnp.asarray(by), jnp.asarray(bx),
        jnp.asarray(blocks), bs))
    got = tinter._scatter_blocks(T(plane.copy()), T(by), T(bx), T(blocks),
                                 bs)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_block_grid_add_matches_jax(n):
    rng = np.random.default_rng(n)
    h, w = 64, 96
    plane = rng.integers(0, 1024, (h, w)).astype(np.int16)
    cells = rng.permutation((h // n) * (w // n))[:5]
    ys = (cells // (w // n) * n).astype(np.int32)
    xs = (cells % (w // n) * n).astype(np.int32)
    res = rng.integers(-1200, 1200, (len(cells), n, n)).astype(np.int32)
    want = np.asarray(jpipe._block_grid_add(
        jnp.asarray(plane), jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(res), n, 1023))
    got = ttransform._block_grid_add(T(plane.copy()), T(xs), T(ys), T(res),
                                     n, 1023)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
