"""SAO of whole pictures in the port (turingcodec_tpu_torch.ops.sao:
sao_picture_device, sao_picture_frames and sao_neighbour_mask) against the
JAX package's sao_picture_device and _sao_plane: every SAO picture of
tests/streams/vfy_sweep.hevc, and synthetic pictures from
tools/loop_filter_check.sao_picture_synthetic (8, 10, 13 and 16 bits,
luma and chroma depths apart, CTB 16, 32 and 64, sides no multiple of 64,
slices that end mid-row with mixed across flags and a CTB no slice
covers, tiles, PCM and transquant-bypass blocks, monochrome). Every value
is an integer: equality is exact (tolerance 0). On CPU tensors the
wrappers run the plain version and count no launch.

The per-CTB neighbour mask is the premise of the kernel's rule: a
sample's edge offset is valid where both neighbours lie in the picture
and the mask of the sample's CTB holds both neighbours' CTBs; the tests
hold that equal to the plain version's per-sample rule.

The cases marked `cuda` hold the kernel's one launch per picture against
the plain version on the card and skip without one; this file imports the
JAX package only in the fixture of the CPU cases:
python -m pytest --noconftest -m cuda tests/test_torch_sao_picture.py
"""
import os

import numpy as np
import pytest
import torch

from turingcodec_tpu_torch.ops import sao as tsao
from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures
from turingcodec_tpu_torch.tools.loop_filter_check import (
    sao_picture_synthetic)

STREAMS = os.path.join(os.path.dirname(__file__), "streams")
VFY_SAO_PICTURES = 9


@pytest.fixture(scope="module")
def jsao():
    import turingcodec_tpu.ops.sao as jsao
    return jsao


@pytest.fixture(scope="module")
def vfy_sao():
    with open(os.path.join(STREAMS, "vfy_sweep.hevc"), "rb") as f:
        return [p for p in capture_pictures(f.read()) if p["sao"] is not None]


def _jax_picture(jsao, plan, geom, planes):
    return [np.asarray(p) for p in jsao.sao_picture_device(
        plan, geom, [p.copy() for p in planes])]


def test_vfy_sweep_has_its_sao_pictures(vfy_sao):
    assert len(vfy_sao) == VFY_SAO_PICTURES


@pytest.mark.parametrize("i", range(VFY_SAO_PICTURES))
def test_sao_picture_plain_matches_jax_on_vfy_sweep(jsao, vfy_sao, i,
                                                    monkeypatch):
    p = vfy_sao[i]
    monkeypatch.setattr(tsao, "launches", 0)
    got = tsao.sao_picture_device(p["plan"], p["geom"], p["post"], "cpu")
    want = _jax_picture(jsao, p["plan"], p["geom"], p["post"])
    for g, w, host in zip(got, want, p["sao"]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, host)
    assert tsao.launches == 0


# (h, w, bd_y, bd_c, ctb, chroma, slices): sides no multiple of 64 (and
# 72x104 none of 16 in the chroma's CTB grid), mixed depths, monochrome
SYNTHETIC = [(136, 200, 8, 8, 64, True, 3), (72, 104, 10, 10, 16, True, 5),
             (96, 160, 16, 16, 32, True, 4), (88, 120, 8, 10, 32, True, 6),
             (56, 136, 13, 13, 16, True, 9), (136, 200, 10, 10, 64, False, 3),
             (40, 72, 16, 16, 16, False, 4)]


@pytest.mark.parametrize("case", SYNTHETIC)
def test_sao_picture_plain_matches_jax_synthetic(jsao, case, monkeypatch):
    h, w, bd_y, bd_c, ctb, chroma, n_sl = case
    rng = np.random.default_rng(h * w + bd_y + ctb)
    plan, geom, planes = sao_picture_synthetic(rng, h, w, bd_y, bd_c, ctb,
                                               chroma, n_sl)
    monkeypatch.setattr(tsao, "launches", 0)
    got = tsao.sao_picture_device(plan, geom, planes, "cpu")
    want = _jax_picture(jsao, plan, geom, planes)
    assert len(got) == len(want) == 3
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    n = 3 if chroma else 1
    # every coded component changed, the others passed through
    assert all(not np.array_equal(got[c], planes[c]) for c in range(n))
    assert all(np.array_equal(got[c], planes[c]) for c in range(n, 3))
    assert tsao.launches == 0


def _picture_args(plan, geom, planes, device="cpu"):
    maps = tsao._picture_maps(plan, geom, "cpu")
    n = 3 if plan.sps.chroma_array_type else 1
    args = tsao.sao_picture_args(
        plan, maps, [torch.from_numpy(p) for p in planes[:n]])
    return [[p.to(device) for p in a] if isinstance(a, list)
            else a.to(device) if isinstance(a, torch.Tensor) else a
            for a in args]


def test_sao_picture_frames_batch_equals_per_picture_calls(monkeypatch):
    """Three pictures stacked on the frame axis, each with its own
    across-tiles flag, equal to their own calls; the components equal
    sao_frames's one at a time."""
    pics = [sao_picture_synthetic(np.random.default_rng(70 + i), 72, 104,
                                  10, 10, 32) for i in range(3)]
    one = [_picture_args(*p) for p in pics]
    flags = torch.tensor([True, False, True])
    monkeypatch.setattr(tsao, "launches", 0)
    got = tsao.sao_picture_frames(
        [torch.cat([a[0][c] for a in one]) for c in range(3)], *one[0][1:4],
        *(torch.cat([a[k] for a in one]) for k in range(4, 11)), flags,
        torch.cat([a[12] for a in one]))
    for i, a in enumerate(one):
        want = tsao.sao_picture_frames(*a[:11], bool(flags[i]), a[12])
        for c in range(3):
            assert torch.equal(got[c][i:i + 1], want[c])
            ctb, bd = a[1] >> (c > 0), a[2 + (c > 0)]
            assert torch.equal(want[c], tsao.sao_frames(
                a[0][c], ctb, bd, 1 + (c > 0), a[4][:, c], a[5][:, c],
                a[6][:, c], a[7], a[8], a[9][:, c], a[10], bool(flags[i]),
                a[12]))
    assert tsao.launches == 0


def _layout(rng, hc, wc, n_slices, tiles, negative):
    """Per-CTB slice ids in raster order (cuts anywhere: slices end
    mid-row), a tile grid, per-slice across flags mixed, and optionally
    CTBs no slice covers (-1)."""
    n = hc * wc
    cuts = np.sort(rng.choice(np.arange(1, n), n_slices - 1, replace=False))
    slice_ctb = np.searchsorted(cuts, np.arange(n), side="right") \
        .astype(np.int32).reshape(hc, wc)
    if negative:
        slice_ctb.flat[rng.choice(n, 3, replace=False)] = -1
    ty, tx = tiles
    tile_ctb = ((np.arange(hc)[:, None] * ty // hc) * tx
                + np.arange(wc)[None, :] * tx // wc).astype(np.int32)
    across = rng.random(n_slices) < 0.5
    across[:2] = (False, True)
    return (torch.from_numpy(slice_ctb), torch.from_numpy(tile_ctb),
            torch.from_numpy(across))


def _mask_valid(mask, ctb, eo, h, w):
    """Per sample, an edge offset of class eo valid by the mask: both
    neighbours in the picture, and both their CTBs held by the mask of
    the sample's CTB."""
    ady, adx = tsao._EO_A[eo]
    ys = torch.arange(h)[:, None]
    xs = torch.arange(w)[None, :]
    cy, cx = ys // ctb, xs // ctb
    ok = torch.ones((h, w), dtype=torch.bool)
    for sy, sx in ((ady, adx), (-ady, -adx)):
        ny, nx = ys + sy, xs + sx
        inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        dy = (ny.clamp(0, h - 1) // ctb - cy + 1).expand(h, w)
        dx = (nx.clamp(0, w - 1) // ctb - cx + 1).expand(h, w)
        ok &= inside & mask[cy.expand(h, w), cx.expand(h, w), dy, dx]
    return ok


@pytest.mark.parametrize("across_tiles", [False, True])
@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("ctb,h,w,n_slices,tiles", [
    (16, 72, 104, 7, (2, 3)), (8, 44, 68, 12, (3, 2)),
    (32, 136, 200, 5, (2, 2)), (64, 136, 200, 3, (1, 2))])
def test_sao_neighbour_mask_matches_per_sample_rule(ctb, h, w, n_slices,
                                                    tiles, negative,
                                                    across_tiles):
    """The kernel's premise: the slice and tile rules once per CTB
    (sao_neighbour_mask) give _sao_plane's per-sample validity exactly,
    for every edge class, on sides no multiple of the CTB."""
    hc, wc = -(-h // ctb), -(-w // ctb)
    rng = np.random.default_rng(hc * wc + n_slices)
    slice_ctb, tile_ctb, across = _layout(rng, hc, wc, n_slices, tiles,
                                          negative)
    mask = tsao.sao_neighbour_mask(slice_ctb, tile_ctb, across, across_tiles)
    assert mask.shape == (hc, wc, 3, 3) and mask[:, :, 1, 1].all()
    slice_up = tsao._up(slice_ctb, ctb, ctb, h, w)
    tile_up = tsao._up(tile_ctb, ctb, ctb, h, w)
    for eo in range(4):
        want = tsao._edge_valid(slice_up, tile_up, across, across_tiles, eo)
        assert torch.equal(_mask_valid(mask, ctb, eo, h, w), want), eo
    # the rules do cut: some neighbours in the grid are refused
    cy = torch.arange(hc)[:, None, None, None] + torch.arange(-1, 2)[:, None]
    cx = torch.arange(wc)[None, :, None, None] + torch.arange(-1, 2)
    in_grid = (cy >= 0) & (cy < hc) & (cx >= 0) & (cx < wc)
    assert (in_grid & ~mask).any()


def test_sao_picture_frames_refuses_other_plane_counts():
    args = _picture_args(*sao_picture_synthetic(np.random.default_rng(2),
                                                48, 64, 8))
    with pytest.raises(ValueError):
        tsao.sao_picture_frames(args[0][:2], *args[1:])
    meta = [[p.to("meta") for p in args[0]]] + args[1:]
    with pytest.raises(ValueError, match="unsupported device meta"):
        tsao.sao_picture_frames(*meta)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SYNTHETIC + [
    (1080, 1920, 8, 8, 16, True, 300), (1076, 1916, 10, 10, 32, True, 3)])
def test_sao_picture_kernel_one_launch_on_card(case):
    """One launch for every component of a picture, equal to the plain
    version; the inputs stay as they were (the kernel is out of place).
    300 slices: more than the kernel stages."""
    dev = _card()
    h, w, bd_y, bd_c, ctb, chroma, n_sl = case
    plan, geom, planes = sao_picture_synthetic(
        np.random.default_rng(h + w + bd_y), h, w, bd_y, bd_c, ctb, chroma,
        n_sl)
    args = _picture_args(plan, geom, planes, dev)
    kept = [p.clone() for p in args[0]]
    tsao.launches = 0
    got = tsao.sao_picture_frames(*args)
    assert tsao.launches == 1
    want = tsao.sao_picture_frames(*_picture_args(plan, geom, planes))
    assert all(torch.equal(g.cpu(), w_) for g, w_ in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(args[0], kept))


@pytest.mark.cuda
def test_sao_one_launch_per_picture_in_the_card_decode():
    """vfy_sweep decoded on the card: one SAO launch per SAO-coded
    picture, md5 as the host decode."""
    _card()
    from turingcodec_tpu_torch.decode.decoder import Decoder
    data = open(os.path.join(STREAMS, "vfy_sweep.hevc"), "rb").read()
    tsao.launches = 0
    got = [f.planes for f in Decoder(device="cuda").decode_stream(data)]
    assert tsao.launches == VFY_SAO_PICTURES
    want = [f.planes for f in Decoder(device=None).decode_stream(data)]
    assert all(np.array_equal(a, b) for fa, fb in zip(got, want)
               for a, b in zip(fa, fb))
