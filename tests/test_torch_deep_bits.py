"""The port's decoder above 12 bits against the JAX package, on the CPU
(device="cpu": the kernels' plain versions), exact integers throughout.

- The 13-bit stream of tools/deep_bits.py (seeded frames encoded on the
  port's host path) through Decoder(device="cpu")'s pipeline: the md5 of
  the JAX package's device pipeline (computed here, JAX on the CPU), 0
  hash failures, every picture through the pipeline.
- dequant_idct_add_ref against JAX dequant_batch + inverse_transform_batch
  (and the transform-skip shift, the add and the clip of its
  _residuals_device) at 13, 14 and 16 bits, on seeded TU tables of every
  size and mode; at 16 bits the planes are int16 as the JAX pipeline
  holds them (a sample above 32767 wraps negative in both).
- mc_block_grid's plain version against JAX at 13 and 14 bits.
- At 14 and 16 bits both packages' pipelines raise ValueError("negative
  shift count") from _combine_uni_bi.

The case marked `cuda` decodes the 13-bit stream on the card:
python -m pytest --noconftest -m cuda tests/test_torch_deep_bits.py
"""
import os

import numpy as np
import pytest
import torch

import turingcodec_tpu_torch.ops.inter as tinter
import turingcodec_tpu_torch.ops.transform as ttransform
from turingcodec_tpu_torch.ops.transform import TU_KIND, tu_fields, tu_kind
from turingcodec_tpu_torch.tools import deep_bits

T = torch.from_numpy


@pytest.fixture
def jax_pipeline(monkeypatch):
    """The JAX package's decoder with its device pipeline on."""
    monkeypatch.setenv("TURING_TPU_DEVICE_PIPELINE", "1")
    from turingcodec_tpu.decode.decoder import Decoder
    return Decoder


def test_13_bit_stream_through_the_pipeline_matches_jax(jax_pipeline):
    data = deep_bits.stream(13)
    assert len(data) == 17266
    jdec = jax_pipeline()
    want = deep_bits.planes_md5(list(jdec.decode_stream(data)))
    assert jdec.hash_failures == 0
    assert want == deep_bits.JAX_MD5_13
    md5, n, fails, piped = deep_bits.decode(data, "cpu")
    assert (md5, n, fails, piped) == (want, 3, 0, 3)


@pytest.mark.parametrize("bd", [14, 16])
def test_deep_pipelines_raise_alike(jax_pipeline, bd):
    """The shift 14 - bd of the default weighted prediction is negative
    for the rounding term: a trait of the reference that the port keeps."""
    data = deep_bits.stream(bd)
    with pytest.raises(ValueError, match="^negative shift count$") as jx:
        list(jax_pipeline().decode_stream(data))
    with pytest.raises(ValueError, match="^negative shift count$") as pt:
        deep_bits.decode(data, "cpu")
    assert (deep_bits.raised_in(jx.value) == deep_bits.raised_in(pt.value)
            == "_combine_uni_bi")


def _tus(rng, bd, h=72, w=104):
    """Level and predicted planes of a 4:2:0 picture, and a table of
    disjoint TUs of every size and mode on every component with QPs over
    0..51 + 6 * (bd - 8), some touching the right and bottom edges."""
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    qp_max = 51 + 6 * (bd - 8)
    coeff, planes, rows = [], [], []
    cell = 0
    for c, (hh, ww) in enumerate(shapes):
        lv = rng.integers(-300, 301, (hh, ww))
        big = rng.random((hh, ww)) < 0.05
        lv[big] = rng.choice([-32768, 32767], int(big.sum()))
        coeff.append(lv.astype(np.int16))
        planes.append(rng.integers(0, 1 << bd, (hh, ww))
                      .astype(np.uint16).view(np.int16))
        for y0 in range(0, hh, 32):
            for x0 in range(0, ww, 32):
                # the sizes in turn where a whole cell fits, else 4x4
                inside = y0 + 32 <= hh and x0 + 32 <= ww
                lg = 5 - cell % 4 if inside else 2
                cell += inside
                n = 1 << lg
                for y in range(y0, min(y0 + 32, hh - n + 1), n):
                    for x in range(x0, min(x0 + 32, ww - n + 1), n):
                        rows.append((x, y, int(rng.integers(0, qp_max + 1)),
                                     tu_kind(c, lg, int(rng.integers(0, 3)))))
    return coeff, planes, np.array(rows, np.int32)


def _jax_residual_add(coeff, planes, table, bd):
    """The JAX pipeline's residual stage per (component, size, mode)
    group: dequant_batch, then inverse_transform_batch (mode 0), the
    transform-skip shift (mode 1) or the raw levels (mode 2), added and
    clipped by its _block_grid_add into the int16 planes."""
    import jax.numpy as jnp

    import turingcodec_tpu.decode.device_pipeline as jpipe
    from turingcodec_tpu.ops.quant import dequant_batch
    from turingcodec_tpu.ops.transform import inverse_transform_batch
    out = [jnp.asarray(p) for p in planes]
    comp, log2, mode = tu_fields(table[:, TU_KIND])
    for c, lg, md in sorted(set(zip(comp.tolist(), log2.tolist(),
                                    mode.tolist()))):
        sel = np.nonzero((comp == c) & (log2 == lg) & (mode == md))[0]
        n = 1 << lg
        lv = jnp.asarray(np.stack([coeff[c][y:y + n, x:x + n]
                                   for x, y in table[sel, :2]])
                         .astype(np.int32))
        qp = jnp.asarray(table[sel, 2])
        if md == 2:
            res = lv
        elif md == 1:
            d = dequant_batch(lv, qp, bd, lg)
            sh = 20 - bd
            res = jnp.clip(((d << 7) + (1 << (sh - 1))) >> sh, -32768,
                           32767)
        else:
            res = inverse_transform_batch(dequant_batch(lv, qp, bd, lg), bd,
                                          False)
        out[c] = jpipe._block_grid_add(out[c], jnp.asarray(table[sel, 0]),
                                       jnp.asarray(table[sel, 1]), res, n,
                                       (1 << bd) - 1)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("bd", [13, 14, 16])
def test_dequant_idct_add_ref_matches_jax(bd):
    """Through the plain version and through the wrapper on CPU tensors
    (which launches nothing)."""
    coeff, planes, table = _tus(np.random.default_rng(bd), bd)
    _comp, sizes, modes = tu_fields(table[:, TU_KIND])
    assert set(modes.tolist()) == {0, 1, 2}
    assert set(sizes.tolist()) == {2, 3, 4, 5}
    want = _jax_residual_add(coeff, planes, table, bd)
    before = ttransform.launches
    for fn in (ttransform.dequant_idct_add_ref, ttransform.dequant_idct_add):
        got = fn([T(c) for c in coeff], [T(p.copy()) for p in planes],
                 table, (bd, bd, bd))
        for g, w in zip(got, want):
            assert g.dtype == torch.int16
            np.testing.assert_array_equal(g.numpy(), w)
    assert any(not np.array_equal(w, p) for w, p in zip(want, planes))
    assert ttransform.launches == before


@pytest.mark.parametrize("bd", [13, 14])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_mc_block_grid_matches_jax_deep(bd, plane):
    """Every phase, full-pel (the shift 14 - bd) and windows past every
    edge, two lists in one call."""
    import jax.numpy as jnp

    import turingcodec_tpu.ops.inter as jinter
    bs, taps, phases = (4, 8, 4) if plane == "luma" else (2, 4, 8)
    rng = np.random.default_rng(bd * 10 + taps)
    h, w, b = 40, 56, 2 * phases * phases
    k = np.arange(b)
    refs = [rng.integers(0, 1 << bd, (r, h, w)).astype(np.int16)
            for r in (3, 2)]
    per_list = []
    for lx, r in enumerate((3, 2)):
        full = k >= phases * phases          # the second half full-pel
        per_list.append([a.astype(np.int32) for a in (
            rng.integers(0, r, b), rng.integers(-16, w + 8, b),
            rng.integers(-16, h + 8, b), np.where(full, 0, k % phases),
            np.where(full, 0, k // phases % phases))])
    comps = 1 if plane == "luma" else 2
    lists = [[refs[lx] ^ c for c in range(comps)] for lx in range(2)]
    want = [[np.asarray(jinter.mc_block_grid(
        jnp.asarray(r), *[jnp.asarray(a) for a in per_list[lx]], bs, taps,
        bd)) for r in lst] for lx, lst in enumerate(lists)]
    before = tinter.launches
    got = tinter.mc_block_grid([[T(c) for c in lst] for lst in lists],
                               *[T(np.stack(a)) for a in zip(*per_list)],
                               bs, taps, bd)
    assert tinter.launches == before
    for g_l, w_l in zip(got, want):
        for g, wnt in zip(g_l, w_l):
            np.testing.assert_array_equal(g.numpy(), wnt)


@pytest.mark.cuda
def test_13_bit_stream_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    import turingcodec_tpu_torch.ops.deblock as tdeblock
    os.environ.pop("TURING_TPU_DEVICE_PIPELINE", None)
    tinter.picture_launches = ttransform.launches = tdeblock.launches = 0
    deep_bits.check_13("cuda")
    assert tinter.picture_launches and ttransform.launches
    assert tdeblock.launches == 3      # one per picture
    deep_bits.check_raises("cuda")
