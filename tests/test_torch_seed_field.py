"""The port's lowres seed field (turingcodec_tpu_torch.encode.
device_analysis.seed_field: on CPU tensors its plain version
seed_field_ref, on a card csrc/seed_field.cu) against the JAX package's
_seed_field_program (seed_field_device, and seed_fields_frames_sharded on
a one-device mesh) and the native host twin (native.dense_analysis, whose
seeds come first; 8 and 10 bits, where its 16-bit costs hold).

The sizes reach the edge padding: neither side is a multiple of 4 or 16,
so the decimation clamps to the last full-resolution row and column, and
the decimated planes to their last sample out to the block grid (at
1080 rows, ceil(1080 / 4) = 270 quarter-res rows against a grid of 272).
They also reach the kernel's tiling (8 x 4 blocks a CTA): planes smaller
than one block (1x1, 2x6), a plane one tile wide and ten tall, and sides
= 2 (mod 4) with partial tiles on both, where the quarter-res mean adds
2x2 sums one row and column past the half-res grid.
The inputs, made from a seed with numpy: shifts planted at the quarter-res
window's edge (+-8) and past the half-res one (+-36 full-res samples),
flat planes (every SAD ties; the penalties pick (0, 0)), an inverted
checkerboard (four quarter-res offsets tie at cost 1, three half-res ones
at cost 4: the first in (dy, dx) order wins), 12-bit extremes, and 16-bit
planes whose samples above 32767 wrap in int16, over the whole range and
near zero (negative sums, where the rounded mean must floor). Every value
is an integer: the tolerance is 0.

The cases marked `cuda` hold the kernel against the plain version on the
card at the same inputs and at 1920x1080, and skip without one; this file
imports the JAX package only in fixtures, so they run on a machine without
it:
python -m pytest --noconftest -m cuda tests/test_torch_seed_field.py
"""
import numpy as np
import pytest
import torch

import turingcodec_tpu_torch.encode.device_analysis as tda


@pytest.fixture(scope="module")
def jda():
    import turingcodec_tpu.encode.device_analysis as jda
    return jda


def _smooth(rng, h, w, bd):
    """A textured picture whose SAD surface falls towards a true match:
    random 16x16 cells, bilinearly blended, with noise, over bd bits."""
    ch, cw = h // 16 + 3, w // 16 + 3
    cells = rng.random((ch, cw))
    y = np.arange(h) / 16.0
    x = np.arange(w) / 16.0
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    v = (cells[y0][:, x0] * (1 - fy) * (1 - fx)
         + cells[y0 + 1][:, x0] * fy * (1 - fx)
         + cells[y0][:, x0 + 1] * (1 - fy) * fx
         + cells[y0 + 1][:, x0 + 1] * fy * fx)
    hi = (1 << bd) - 1
    return np.clip(v * hi + rng.normal(0, hi / 200, (h, w)), 0, hi)


def _as_int16(a):
    """Samples of up to 16 bits as the contiguous int16 plane the device
    programs take."""
    return np.ascontiguousarray(
        np.asarray(a, np.int64).astype(np.uint16).view(np.int16))


# name: (h, w, bit depth, kind)
CASES = {
    "shift_8_8bit": (75, 118, 8, "shift8"),
    "shift_36_10bit": (90, 161, 10, "shift36"),
    "flat_8bit": (75, 118, 8, "flat"),
    "checker_8bit": (90, 161, 8, "checker"),
    "extremes_12bit": (1080, 64, 12, "extremes"),
    "wrap_16bit": (67, 131, 16, "wrap"),
    "near_zero_16bit": (67, 131, 16, "near_zero"),
    # planes smaller than one block
    "tiny_1x1_8bit": (1, 1, 8, "extremes"),
    "tiny_2x6_8bit": (2, 6, 8, "shift8"),
    # one kernel tile (8 x 4 blocks) wide and ten tall, the last partial
    "one_tile_wide_8bit": (600, 120, 8, "shift8"),
    # h and w = 2 (mod 4): the 4x4 means read a row and a column of 2x2
    # sums one past the half-res grid; partial tiles on both sides
    "partial_2mod4_10bit": (150, 282, 10, "shift36"),
}


def _pair(name, seed=0):
    h, w, bd, kind = CASES[name]
    rng = np.random.default_rng(seed + h * w + bd)
    hi = (1 << bd) - 1
    if kind in ("shift8", "shift36"):
        # two windows of one larger picture: orig(y, x) = ref(y + s, x - s),
        # at the quarter-res window's corner (s = 32: (-8, +8) quarter-res
        # samples), or past it and at the half-res window's edge (s = -36)
        s = 32 if kind == "shift8" else -36
        big = _smooth(rng, h + 80, w + 80, bd)
        o = big[40:40 + h, 40:40 + w]
        r = big[40 - s:40 - s + h, 40 + s:40 + s + w]
    elif kind == "flat":
        o = np.full((h, w), 77)
        r = np.full((h, w), 77)
    elif kind == "checker":
        yy, xx = np.indices((h, w))
        o = ((yy // 4 + xx // 4) % 2) * hi
        r = hi - o
    elif kind == "extremes":
        o = rng.integers(0, 2, (h, w)) * hi
        r = np.roll(o, (9, -13), (0, 1))
        r[::5] = hi - r[::5]
    elif kind == "wrap":
        o = rng.integers(0, 1 << 16, (h, w))
        r = np.roll(o, (5, -9), (0, 1))
        r[::3] = rng.integers(0, 1 << 16, r[::3].shape)
    else:                                     # near_zero
        o = rng.integers(-6, 6, (h, w))
        r = np.roll(o, (6, -7), (0, 1)) + rng.integers(-2, 3, (h, w))
    return _as_int16(o), _as_int16(r)


@pytest.mark.parametrize("name", list(CASES))
def test_seed_field_matches_jax(jda, name):
    orig, ref = _pair(name)
    got, wb, hb = tda.seed_field_device(orig, ref, "cpu")
    want, wb_j, hb_j = jda.seed_field_device(orig, ref)
    assert (wb, hb) == (wb_j, hb_j) == tda.block_dims(*orig.shape[::-1])
    assert got.dtype == np.int32 and got.shape == (hb, wb, 2)
    np.testing.assert_array_equal(got, want)


def _mode(seeds):
    vals, counts = np.unique(seeds.reshape(-1, 2), axis=0,
                             return_counts=True)
    return tuple(vals[counts.argmax()]), counts.max() / counts.sum()


@pytest.mark.parametrize("name,want", [
    ("shift_8_8bit", (-32, 32)),      # the quarter-res window's corner
    ("shift_36_10bit", (36, -36)),    # its corner, then the refinement's
    ("flat_8bit", (0, 0)),            # every SAD ties: the penalties
    ("checker_8bit", (0, -4)),        # ties: quarter-res (0, -1) first,
])                                    # then half-res (0, -2) first
def test_seed_field_reaches_the_planted_winner(name, want):
    """The inputs do what their names say: the planted shift is the most
    frequent seed (a block whose reference window leaves the picture, as
    most do at +-36, finds another), and the ties go to the first offset
    in scan order."""
    seeds = tda.seed_field_device(*_pair(name), "cpu")[0]
    mode, share = _mode(seeds)
    assert mode == want and share * seeds[..., 0].size >= 3, (mode, share)


@pytest.mark.parametrize("name", ["shift_8_8bit", "shift_36_10bit",
                                  "checker_8bit", "tiny_2x6_8bit",
                                  "partial_2mod4_10bit"])
def test_seed_field_matches_the_native_twin(name):
    from turingcodec_tpu_torch import native
    orig, ref = _pair(name)
    res = native.dense_analysis(orig, ref, CASES[name][2])
    assert res is not None, "native core unavailable"
    got, wb, hb = tda.seed_field_device(orig, ref, "cpu")
    assert (wb, hb) == res[3:5]
    np.testing.assert_array_equal(got, res[0])


def _batch(name, n=3):
    pairs = [_pair(name, seed=i) for i in range(n)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


@pytest.mark.parametrize("name", ["wrap_16bit", "near_zero_16bit"])
def test_batched_seed_fields_match_single_calls_and_jax(jda, name):
    from turingcodec_tpu.parallel import mesh as jmesh

    from turingcodec_tpu_torch.parallel import mesh as tmesh
    origs, refs = _batch(name)
    got, wb, hb = tda.seed_fields_frames_batched(origs, refs, "cpu")
    assert got.shape == (3, hb, wb, 2)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], tda.seed_field_device(origs[i], refs[i], "cpu")[0])
    want, wb_j, hb_j = jda.seed_fields_frames_sharded(jmesh.make_mesh(1, 1),
                                                      origs, refs)
    assert (wb, hb) == (wb_j, hb_j)
    np.testing.assert_array_equal(got, want)
    sharded = tda.seed_fields_frames_sharded(tmesh.make_mesh(1, 1, "cpu"),
                                             origs, refs)
    np.testing.assert_array_equal(sharded[0], got)
    np.testing.assert_array_equal(
        tda.analysis_frames_batched(origs, refs, "cpu")[0], got)


def test_the_plain_version_takes_cpu_tensors_and_counts_no_launch(
        monkeypatch):
    monkeypatch.setattr(tda, "seed_launches", 0)
    orig, ref = _pair("wrap_16bit")
    o, r = torch.from_numpy(orig), torch.from_numpy(ref)
    wb, hb = tda.block_dims(orig.shape[1], orig.shape[0])
    one = tda.seed_field(o, r)
    assert torch.equal(one, tda.seed_field_ref(o, r, wb, hb))
    both = tda.seed_field(torch.stack([o, r]), torch.stack([r, o]))
    assert torch.equal(both[0], one)
    assert torch.equal(both[1], tda.seed_field_ref(r, o, wb, hb))
    none = torch.empty((0,) + o.shape, dtype=torch.int16)
    assert tda.seed_field(none, none).shape == (0, hb, wb, 2)
    assert tda.seed_launches == 0


def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    orig, ref = (torch.from_numpy(a) for a in _pair("wrap_16bit"))
    meta = torch.empty(orig.shape, dtype=torch.int16, device="meta")
    for bad in (lambda: tda.seed_field(orig.to(torch.int32), ref),
                lambda: tda.seed_field(orig, ref[:-1]),
                lambda: tda.seed_field(orig[None, None], ref[None, None]),
                lambda: tda.seed_field(orig[:0], ref[:0]),
                lambda: tda.seed_field(meta, meta),
                lambda: tda.seed_field(orig, meta)):
        with pytest.raises(ValueError):
            bad()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tda.seed_field_device(orig.numpy(), ref.numpy(), "cuda")


def test_the_probe_splits_this_trees_kernel():
    """tools/seed_probe.py's --split finds this tree's decimation and
    searches: one variant keeps the loads and drops the searches, the
    other the reverse."""
    import os

    from turingcodec_tpu_torch.ops import kernel_build
    from turingcodec_tpu_torch.tools import seed_probe
    src = os.path.join(kernel_build.CSRC, "seed_field.cu")
    variants = seed_probe.split_variants(src)
    body = {k: v.split("seed_field_kernel(")[1].split("}  // namespace")[0]
            for k, v in variants.items()}
    assert "sums2x2<" in body["decimation alone"]
    assert "2. quarter-res" not in body["decimation alone"]
    assert "sums2x2<" not in body["searches alone"]
    assert "2. quarter-res" in body["searches alone"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES) + ["1080p"])
def test_kernel_matches_plain_on_card(name):
    dev = _card()
    if name == "1080p":
        rng = np.random.default_rng(3)
        orig = _as_int16(_smooth(rng, 1080, 1920, 8))
        ref = _as_int16(np.roll(orig, (7, -11), (0, 1)))
    else:
        orig, ref = _pair(name)
    h, w = orig.shape
    wb, hb = tda.block_dims(w, h)
    o, r = (torch.from_numpy(a).to(dev) for a in (orig, ref))
    tda.seed_launches = 0
    got = tda.seed_field(o, r)
    torch.cuda.synchronize()
    assert tda.seed_launches == 1
    assert torch.equal(got, tda.seed_field_ref(o, r, wb, hb))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["shift_36_10bit", "near_zero_16bit"])
def test_batched_kernel_is_one_launch_equal_to_single_calls(name):
    dev = _card()
    origs, refs = (torch.from_numpy(a).to(dev) for a in _batch(name))
    wb, hb = tda.block_dims(origs.shape[2], origs.shape[1])
    tda.seed_launches = 0
    got = tda.seed_field(origs, refs)
    assert tda.seed_launches == 1
    for i in range(origs.shape[0]):
        assert torch.equal(got[i], tda.seed_field_ref(origs[i], refs[i],
                                                      wb, hb))
