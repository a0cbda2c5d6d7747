"""The encoder analysis kernels' plain versions (turingcodec_tpu_torch.
encode.device_analysis: rank_satd_tables and subpel_planes on CPU tensors,
which take _rank_table and _subpel_planes) against the JAX package's
device programs, on numpy inputs made from a seed: 8 to 16 bits, strong
smoothing on and off, flat regions, odd shapes, 0/max checkerboards (for
the rank tables those are the largest differences that the kernel's
packed butterflies meet, at 8 and 10 bits). Every
value is an integer: equality is exact (tolerance 0). At 16 bits both
packages pass the samples through int16, so neither equals its numpy host
twin there; the kernels keep that trait.

The cases marked `cuda` hold the CUDA kernels against the plain versions
on the card and skip without one; this file imports the JAX package only
in the fixture of the CPU cases, so they run on a machine without it:
python -m pytest --noconftest -m cuda tests/test_torch_analysis_kernels.py
"""
import gc

import numpy as np
import pytest
import torch

import turingcodec_tpu_torch.encode.device_analysis as tda


@pytest.fixture(scope="module")
def jda():
    import turingcodec_tpu.encode.device_analysis as jda
    return jda


def _zscan(w, h):
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    return Encoder(EncoderConfig(width=w, height=h, qp=32, rd_candidates=2,
                                 device=None)).geom.zscan


def _as_int16(a):
    """Samples of up to 16 bits as the int16 the device programs take."""
    return np.asarray(a, np.int64).astype(np.uint16).view(np.int16)


def _rank_plane(w, h, bd, seed):
    """Random samples with a flat patch (a slope of +-1 around mid-grey)
    wide enough for 32x32 blocks whose references pass both flatness
    tests."""
    rng = np.random.RandomState(seed)
    plane = rng.randint(0, 1 << bd, (h, w))
    mid = 1 << (bd - 1)
    plane[:, 16:] = mid + (np.add.outer(np.arange(h), np.arange(w - 16))
                           % 3) - 1
    plane[h // 2:, w // 2:] = rng.randint(0, 1 << bd, (h - h // 2,
                                                       w - w // 2))
    return _as_int16(plane)


# 72 is no multiple of 32: the last column of 32x32 blocks is cut
RANK_GEOMS = [(72, 40), (128, 96)]


@pytest.mark.parametrize("strong", [True, False])
@pytest.mark.parametrize("bd", [8, 10, 12, 14, 16])
@pytest.mark.parametrize("geom", RANK_GEOMS)
def test_rank_tables_plain_match_jax(jda, geom, bd, strong):
    w, h = geom
    plane = _rank_plane(w, h, bd, seed=bd)
    zscan = _zscan(w, h)
    got = tda.rank_satd_tables_device(plane, zscan, bd, strong, "cpu")
    want = jda.rank_satd_tables_device(plane, zscan, bd, strong)
    assert list(got) == list(want) == [4, 8, 16, 32]
    for n in want:
        assert got[n].dtype == np.int32
        assert got[n].shape == (h // n, w // n, 35)
        np.testing.assert_array_equal(got[n], want[n], err_msg=f"n={n}")


def _checkerboard(w, h, bd, cell):
    """0 / max squares of cell x cell samples: the largest differences the
    rank kernel's packed butterflies meet."""
    yy, xx = np.indices((h, w))
    return _as_int16((yy // cell + xx // cell) % 2 * ((1 << bd) - 1))


@pytest.mark.parametrize("cell", [1, 4, 8])
@pytest.mark.parametrize("bd", [8, 10])
def test_rank_tables_plain_match_jax_on_checkerboards(jda, bd, cell):
    w, h = RANK_GEOMS[0]
    plane = _checkerboard(w, h, bd, cell)
    zscan = _zscan(w, h)
    got = tda.rank_satd_tables_device(plane, zscan, bd, True, "cpu")
    want = jda.rank_satd_tables_device(plane, zscan, bd, True)
    assert list(got) == list(want) == [4, 8, 16, 32]
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=f"n={n}")


@pytest.mark.parametrize("bd", [8, 12])
def test_rank_ops_at_1080p(bd):
    """chip_smoke.py's count of the rank tables' INT32 operations at one
    1080p picture: at 8 bits every butterfly on a packed pair of modes
    counts once, at 12 bits every mode has its own."""
    import chip_smoke
    want = {8: 2512573440, 12: 3304458240}[bd]
    assert chip_smoke.rank_ops(1080, 1920, bd) == want
    t, side = chip_smoke.rank_bound(1080, 1920, bd)
    assert side == "operations" and t == pytest.approx(
        want / chip_smoke.INT32_OPS_PER_S * 1e3)


@pytest.mark.parametrize("bd", [8, 10, 12, 14, 16])
def test_flat_patch_takes_strong_smoothing(bd):
    """The flat patch reaches the strong filter: strong smoothing changes
    the 32x32 table and no other."""
    w, h = RANK_GEOMS[1]
    plane = _rank_plane(w, h, bd, seed=bd)
    zscan = _zscan(w, h)
    on = tda.rank_satd_tables_device(plane, zscan, bd, True, "cpu")
    off = tda.rank_satd_tables_device(plane, zscan, bd, False, "cpu")
    for n in (4, 8, 16):
        np.testing.assert_array_equal(on[n], off[n])
    assert not np.array_equal(on[32], off[32])


def test_rank_sizes_subset_in_the_callers_order(jda):
    w, h = RANK_GEOMS[0]
    plane = _rank_plane(w, h, 10, seed=3)
    zscan = _zscan(w, h)
    got = tda.rank_satd_tables_device(plane, zscan, 10, True, "cpu",
                                      sizes=(32, 8))
    want = jda.rank_satd_tables_device(plane, zscan, 10, True,
                                       sizes=(32, 8))
    assert list(got) == list(want) == [32, 8]
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def _subpel_plane(shape, bd, kind, seed):
    hi = (1 << bd) - 1
    if kind == "checkerboard":       # 0 / max: the largest taps
        plane = np.where(np.add.outer(np.arange(shape[0]),
                                      np.arange(shape[1])) % 2, hi, 0)
    else:
        plane = np.random.RandomState(seed).randint(0, hi + 1, shape)
    return _as_int16(plane)


@pytest.mark.parametrize("kind", ["random", "checkerboard"])
@pytest.mark.parametrize("shape", [(22, 37), (9, 5), (1, 1)])
@pytest.mark.parametrize("bd", [8, 10, 12, 15, 16])
def test_subpel_planes_plain_match_jax(jda, bd, shape, kind):
    ref = _subpel_plane(shape, bd, kind, seed=bd + shape[1])
    got = tda.subpel_planes_device(ref, bd, "cpu")
    h, w = shape
    assert got.dtype == np.int16 and got.shape == (15, h + 56, w + 56)
    np.testing.assert_array_equal(got, jda.subpel_planes_device(ref, bd))


def test_int16_trait_at_16_bits(jda):
    """At 16 bits the samples above 32767 wrap in the int16 upload: both
    packages' device values differ from the numpy host twins (first
    differing value, subpel plane 0 at (0, 0): -981 against 15403), and
    agree with them at 15 bits."""
    ref = _as_int16(np.random.RandomState(7).randint(0, 1 << 16, (22, 37)))
    got = tda.subpel_planes_device(ref, 16, "cpu")
    host = jda.subpel_planes_host(ref.view(np.uint16), 16)
    assert (got[0, 0, 0], host[0, 0, 0]) == (-981, 15403)
    ref15 = np.random.RandomState(7).randint(0, 1 << 15, (22, 37))
    np.testing.assert_array_equal(
        tda.subpel_planes_device(ref15, 15, "cpu"),
        jda.subpel_planes_host(ref15, 15))


def test_cpu_calls_leave_the_counters(monkeypatch):
    monkeypatch.setattr(tda, "rank_launches", 0)
    monkeypatch.setattr(tda, "subpel_launches", 0)
    w, h = RANK_GEOMS[0]
    plane = _rank_plane(w, h, 8, seed=1)
    tda.rank_satd_tables_device(plane, _zscan(w, h), 8, True, "cpu")
    tda.subpel_planes_device(plane, 8, "cpu")
    assert tda.rank_launches == 0 and tda.subpel_launches == 0


def test_cuda_requests_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plane = _rank_plane(64, 64, 8, seed=1)
    with pytest.raises(RuntimeError):
        tda.subpel_planes_device(plane, 8, "cuda")
    with pytest.raises(RuntimeError):
        tda.rank_satd_tables_device(plane, _zscan(64, 64), 8, True, "cuda")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    plane = torch.from_numpy(_rank_plane(64, 64, 8, seed=1))
    zscan = _zscan(64, 64)
    meta = torch.empty((64, 64), dtype=torch.int16, device="meta")
    for bad in (lambda: tda.subpel_planes(meta, 8),
                lambda: tda.rank_satd_tables(meta, zscan, 8, True),
                lambda: tda.subpel_planes(plane, 7),
                lambda: tda.rank_satd_tables(plane, zscan, 17, True),
                lambda: tda.subpel_planes(plane.to(torch.int32), 8),
                lambda: tda.rank_satd_tables(plane.t(), zscan, 8, True),
                lambda: tda.rank_satd_tables(plane, zscan[:8], 8, True),
                lambda: tda.rank_satd_tables(plane, zscan, 8, True, (64,))):
        with pytest.raises(ValueError):
            bad()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 16])
def test_kernels_match_plain_on_card(bd):
    dev = _card()
    w, h = 200, 136
    plane = torch.from_numpy(_rank_plane(w, h, bd, seed=bd)).to(dev)
    zscan = _zscan(w, h)
    tda.rank_launches = tda.subpel_launches = 0
    for strong in (True, False):
        got = tda.rank_satd_tables(plane, zscan, bd, strong)
        want = tda.rank_satd_tables_ref(plane, zscan, bd, strong)
        assert list(got) == list(want)
        for n in want:
            assert torch.equal(got[n], want[n]), n
    sub = tda.subpel_planes(plane, bd)
    assert torch.equal(sub, tda._subpel_planes(plane.to(torch.int32), bd))
    assert tda.rank_launches == 8 and tda.subpel_launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 16])
@pytest.mark.parametrize("hw", [(136, 200), (136, 203), (136, 204),
                                (9, 5), (1, 1), (8, 8), (40, 64)])
def test_subpel_kernel_store_paths_on_card(hw, bd):
    """Both store paths of the subpel kernel: TMA tensor stores where the
    padded width is a multiple of 8 (w = 200), the threads' own stores of
    the staging tile where it is not (w = 203, 204; the ragged last tile
    clipped either way), and planes smaller than one tile, whose source
    windows clamp at every edge: 9x5 and 1x1 on the threads' stores, 8x8
    and 64x40 (padded widths 64 and 120) on the TMA's, whose box is wider
    than the output there."""
    dev = _card()
    h, w = hw
    plane = torch.from_numpy(_subpel_plane((h, w), bd, "random",
                                           seed=bd + w)).to(dev)
    tda.subpel_launches = 0
    sub = tda.subpel_planes(plane, bd)
    assert sub.shape == (15, h + 56, w + 56)
    assert torch.equal(sub, tda._subpel_planes(plane.to(torch.int32), bd))
    assert tda.subpel_launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12, 14])
def test_subpel_kernel_exact_for_any_int16(bd):
    """The kernel's int32 sums are exact for any int16 sample: samples
    over the whole int16 range (the right half of the plane; the left
    half in range) equal the plain version."""
    dev = _card()
    h, w = 136, 200
    rng = np.random.RandomState(bd)
    plane = rng.randint(0, 1 << bd, (h, w))
    plane[:, w // 2:] = rng.randint(-32768, 32768, (h, w - w // 2))
    x = torch.from_numpy(plane.astype(np.int16)).to(dev)
    assert torch.equal(tda.subpel_planes(x, bd),
                       tda._subpel_planes(x.to(torch.int32), bd))


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
def test_rank_kernel_matches_plain_on_checkerboards(bd):
    """The packed butterflies at their largest differences, on a plane
    whose sides are no multiple of 32."""
    dev = _card()
    w, h = 200, 136
    zscan = _zscan(w, h)
    for cell in (1, 4, 8):
        plane = torch.from_numpy(_checkerboard(w, h, bd, cell)).to(dev)
        got = tda.rank_satd_tables(plane, zscan, bd, True)
        want = tda.rank_satd_tables_ref(plane, zscan, bd, True)
        for n in want:
            assert torch.equal(got[n], want[n]), (cell, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width_4_mod_8", "odd_width",
                                  "odd_offset"])
def test_rank_kernel_matches_plain_on_unaligned_rows(case):
    """The kernel's sample-at-a-time block load: rows that 16-byte loads
    cannot take (a width of 4 mod 8, an odd width) or a plane starting at
    an odd element of its buffer."""
    dev = _card()
    w, h = {"width_4_mod_8": (204, 136), "odd_width": (203, 136),
            "odd_offset": (200, 136)}[case]
    plane = torch.from_numpy(_rank_plane(w, h, 8, seed=5)).to(dev)
    if case == "odd_offset":
        buf = torch.empty(w * h + 1, dtype=torch.int16, device=dev)
        buf[1:] = plane.reshape(-1)
        plane = buf[1:].view(h, w)
        assert plane.data_ptr() % 4 == 2
    zscan = _zscan(-(-w // 8) * 8, h)   # the encoder's geometry: sides of 8k
    got = tda.rank_satd_tables(plane, zscan, 8, True)
    want = tda.rank_satd_tables_ref(plane, zscan, 8, True)
    assert list(got) == list(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.cuda
def test_downloads_are_pinned_views():
    _card()
    plane = _rank_plane(72, 40, 8, seed=2)
    sub = tda.subpel_planes_device(plane, 8, "cuda")
    tabs = tda.rank_satd_tables_device(plane, _zscan(72, 40), 8, True,
                                       "cuda")
    for arr in [sub] + list(tabs.values()):
        assert isinstance(arr.base, torch.Tensor) and arr.base.is_pinned()
    np.testing.assert_array_equal(sub, tda.subpel_planes_device(plane, 8,
                                                                "cpu"))


@pytest.mark.cuda
def test_zscan_uploads_leave_with_their_arrays():
    dev = _card()
    plane = torch.from_numpy(_rank_plane(72, 40, 8, seed=3)).to(dev)
    gc.collect()
    held = len(tda._ZSCAN)
    zscan = _zscan(72, 40)
    first = tda.rank_satd_tables(plane, zscan, 8, True)
    tda.rank_satd_tables(plane, zscan, 8, True)
    assert len(tda._ZSCAN) == held + 1
    for _ in range(3):   # each encoder builds its own z-scan array
        tabs = tda.rank_satd_tables(plane, _zscan(72, 40), 8, True)
        assert all(torch.equal(first[n], tabs[n]) for n in first)
    gc.collect()
    assert len(tda._ZSCAN) == held + 1
    del zscan
    gc.collect()
    assert len(tda._ZSCAN) == held
