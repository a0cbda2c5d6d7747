"""ops/inter.mc_picture, the decoder pipeline's MC stage in one launch, on
the CPU (its plain version, mc_picture_ref), exact integers throughout.

- Against the staged chain it replaces (device_recon._predict, whose
  mc_block_grid and _combine_uni_bi run per gathered block, and the scatter
  of its blocks into the planes), on every inter picture of vfy_sweep
  (blocks on list 0 only, on list 1 only and on both) and smp_g4, captured
  in the pipeline's own decode, and on synthetic maps and planes at 8, 10
  and 13 bits: every phase, windows past every edge, reference indices past
  a list's end, blocks marked inter that use no list, samples outside the
  inter blocks left as they were.
- The wrapper refuses what the kernel does not take, raises the reference's
  ValueError("negative shift count") from _combine_uni_bi at 14 and 16
  bits, refuses a device other than the CPU and CUDA, and on CUDA without a
  card raises rather than falling back.

The kernel itself is held against mc_picture_ref on the card by
chip_smoke.py (the 1080p random-access decode's pictures and the 13-bit
stream of tools/deep_bits.py).
"""
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import turingcodec_tpu_torch.decode.device_pipeline as dp
import turingcodec_tpu_torch.decode.device_recon as trecon
import turingcodec_tpu_torch.ops.inter as tinter
from turingcodec_tpu_torch.decode.decoder import Decoder
from turingcodec_tpu_torch.tools import deep_bits

STREAMS = os.path.join(os.path.dirname(__file__), "streams")
T = torch.from_numpy


def _staged(plan, refs, base):
    """The staged chain's planes: base's copies with _predict's blocks
    scattered in (nothing where _inter_blocks finds no block)."""
    out = [p.clone() for p in base]
    blocks = trecon._inter_blocks(plan)
    if blocks is None:
        return out
    by4, bx4 = blocks
    preds = trecon._predict(plan, by4, bx4, refs, "cpu")
    return [tinter._scatter_blocks(p, T(by4), T(bx4), pred, bs)
            for p, pred, bs in zip(out, preds, (4, 2, 2))]


def _fused(plan, refs, base, inter):
    sps = plan.sps
    return tinter.mc_picture(
        [p.clone() for p in base], refs, T(inter.astype(np.uint8)),
        T(plan.ref_idx), T(plan.mv), (sps.bit_depth_y, sps.bit_depth_c))


def _kinds(plan, inter):
    """Blocks predicted from list 0 alone, list 1 alone, both."""
    on0 = inter & (plan.ref_idx[0] >= 0)
    on1 = inter & (plan.ref_idx[1] >= 0)
    return np.array([(on0 & ~on1).sum(), (on1 & ~on0).sum(),
                     (on0 & on1).sum()])


@pytest.mark.parametrize("name", ["vfy_sweep.hevc", "smp_g4.hevc"])
def test_plain_matches_the_staged_chain_on_every_inter_picture(
        name, monkeypatch):
    seen, kinds = [], np.zeros(3, np.int64)
    stage = dp._mc_device

    def hook(plan, ref_lists, planes):
        refs = [[dp._dev_planes_for(p, planes[0].device)
                 for p in (ref_lists[lx] if lx < len(ref_lists) else [])]
                for lx in (0, 1)]
        # the maps' own mark of an inter CU: blocks that use no list are
        # the wrapper's to skip
        inter = (plan.cu_pred_mode == 0) & (plan.cu_id >= 0)
        if trecon._inter_blocks(plan) is not None:
            base = [torch.randint(-5, 5, p.shape, dtype=torch.int16)
                    for p in planes]
            want = _staged(plan, refs, base)
            got = _fused(plan, refs, base, inter)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            seen.append(plan)
            kinds[:] += _kinds(plan, inter)
        return stage(plan, ref_lists, planes)

    monkeypatch.setattr(dp, "_mc_device", hook)
    with open(os.path.join(STREAMS, name), "rb") as f:
        frames = list(Decoder(device="cpu").decode_stream(f.read()))
    assert seen and frames
    if name == "vfy_sweep.hevc":
        assert (kinds > 0).all(), kinds


def _synthetic(seed, h4, w4, bds, counts=(3, 2)):
    """A plan of (h4, w4) min-blocks with random maps, its lists' random
    reference pictures at the bit depths, and random base planes."""
    rng = np.random.default_rng(seed)
    bd_y, bd_c = bds
    shapes = [((4 * h4, 4 * w4), bd_y)] + [((2 * h4, 2 * w4), bd_c)] * 2
    refs = [[tuple(T(rng.integers(0, 1 << bd, s).astype(np.int16))
                   for s, bd in shapes) for _ in range(n)] for n in counts]
    inter = rng.random((h4, w4)) < 0.8
    # indices up to one past each list's end (clamped), -1 unused
    ref_idx = np.stack([rng.integers(-1, n + 1, (h4, w4))
                        for n in counts]).astype(np.int8)
    # an inter block of each kind: no list, list 0, list 1, both
    inter[:2, :2] = True
    ref_idx[:, 0, 0] = -1
    if all(counts):
        ref_idx[:, [0, 1, 1], [1, 0, 1]] = [[0, -1, 1], [-1, 0, 1]]
    mv = rng.integers(-64, 64, (2, h4, w4, 2))
    far = rng.random((2, h4, w4, 2)) < 0.1     # windows past every edge
    mv[far] = rng.integers(-16 * (h4 + w4) - 64, 16 * (h4 + w4) + 64,
                           int(far.sum()))
    plan = SimpleNamespace(
        sps=SimpleNamespace(bit_depth_y=bd_y, bit_depth_c=bd_c),
        ref_idx=ref_idx, mv=mv.astype(np.int16),
        cu_pred_mode=np.where(inter, 0, 1).astype(np.uint8),
        cu_id=np.zeros((h4, w4), np.int32))
    base = [T(rng.integers(0, 1 << bd, s).astype(np.int16))
            for s, bd in shapes]
    return plan, refs, base, inter


@pytest.mark.parametrize("bds", [(8, 8), (10, 10), (13, 13), (10, 8)])
@pytest.mark.parametrize("h4,w4", [(18, 26), (5, 3)])
def test_plain_matches_the_staged_chain_on_synthetic_maps(bds, h4, w4):
    plan, refs, base, inter = _synthetic(sum(bds) + h4, h4, w4, bds)
    assert (_kinds(plan, inter) > 0).all()
    assert (inter & (plan.ref_idx < 0).all(0)).any()
    want = _staged(plan, refs, base)
    got = _fused(plan, refs, base, inter)
    for g, w, b in zip(got, want, base):
        assert torch.equal(g, w)
        assert not torch.equal(g, b)


def test_a_picture_of_list0_alone_with_list1_empty():
    plan, refs, base, inter = _synthetic(4, 9, 11, (8, 8), counts=(2, 0))
    plan.ref_idx[1] = -1
    want = _staged(plan, refs, base)
    for g, w in zip(_fused(plan, refs, base, inter), want):
        assert torch.equal(g, w)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    plan, refs, base, inter = _synthetic(5, 6, 8, (8, 8))
    good = dict(planes=base, refs=refs, inter=T(inter.astype(np.uint8)),
                ref_idx=T(plan.ref_idx), mv=T(plan.mv), bit_depths=(8, 8))
    before = tinter.picture_launches
    tinter.mc_picture(**good)
    assert tinter.picture_launches == before   # CPU: the plain version
    bad = [
        ("planes", [base[0].int()] + base[1:], TypeError),
        ("planes", [base[0][:, :-4].contiguous()] + base[1:], TypeError),
        ("planes", [base[0].t().contiguous().t()] + base[1:], ValueError),
        ("planes", base[:2], ValueError),
        ("inter", good["inter"].bool(), TypeError),
        ("inter", good["inter"][None], ValueError),
        ("ref_idx", good["ref_idx"].short(), TypeError),
        ("mv", good["mv"].int(), TypeError),
        ("mv", good["mv"][..., :1].contiguous(), TypeError),
        ("refs", refs[:1], ValueError),
        ("refs", [refs[0] * 6, refs[1]], ValueError),
        ("refs", [[refs[0][0][:2]], refs[1]], ValueError),
        ("refs", [[tuple(p.int() for p in refs[0][0])], refs[1]],
         TypeError),
        ("bit_depths", (7, 8), ValueError),
        ("bit_depths", (8, 7), ValueError),
    ]
    for key, value, err in bad:
        with pytest.raises(err):
            tinter.mc_picture(**dict(good, **{key: value}))
    meta = {k: ([t.to("meta") for t in v] if k == "planes" else
                [[tuple(p.to("meta") for p in pic) for pic in lst]
                 for lst in v] if k == "refs" else
                v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in good.items()}
    with pytest.raises(ValueError, match="unsupported device meta"):
        tinter.mc_picture(**meta)


@pytest.mark.parametrize("bd", [14, 16])
def test_deep_bit_depths_raise_the_references_error(bd):
    plan, refs, base, inter = _synthetic(6, 6, 8, (8, 8))
    with pytest.raises(ValueError, match="^negative shift count$") as e:
        tinter.mc_picture(base, refs, T(inter.astype(np.uint8)),
                          T(plan.ref_idx), T(plan.mv), (bd, 8))
    assert deep_bits.raised_in(e.value) == "_combine_uni_bi"


def test_cuda_without_a_card_raises():
    """No fallback: with no card (and no nvcc) the pipeline's CUDA request
    and the kernel's build raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with open(os.path.join(STREAMS, "smp_g4.hevc"), "rb") as f:
        data = f.read()
    got = []

    def capture(pr, device):
        got.append(pr)
        return None

    real = dp.decode_picture_device
    dp.decode_picture_device = capture
    try:
        for _ in Decoder(device="cpu").decode_stream(data, max_frames=2):
            pass
    finally:
        dp.decode_picture_device = real
    pr = got[-1]
    assert trecon._inter_blocks(pr.plan) is not None
    with pytest.raises((RuntimeError, AssertionError)):
        dp.decode_picture_device(pr, "cuda")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        saved = tinter._PICTURE_LAUNCH
        tinter._PICTURE_LAUNCH = None
        try:
            with pytest.raises(RuntimeError, match="nvcc"):
                tinter._picture_launcher()
        finally:
            tinter._PICTURE_LAUNCH = saved


@pytest.mark.cuda
@pytest.mark.parametrize("bds", [(8, 8), (10, 10), (13, 13)])
def test_kernel_matches_plain_on_card(bds):
    """The kernel against mc_picture_ref on the card: synthetic maps of a
    1080p picture and of a small ragged one, 16 references in each list."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    for h4, w4, counts in ((270, 480, (16, 16)), (5, 3, (3, 2))):
        plan, refs, base, inter = _synthetic(sum(bds), h4, w4, bds, counts)
        cuda = [[tuple(p.cuda() for p in pic) for pic in lst]
                for lst in refs]
        maps = [T(a).cuda() for a in (inter.astype(np.uint8), plan.ref_idx,
                                      plan.mv)]
        before = tinter.picture_launches
        got = tinter.mc_picture([p.cuda() for p in base], cuda, *maps, bds)
        want = tinter.mc_picture_ref([p.cuda() for p in base], cuda, *maps,
                                     bds)
        torch.cuda.synchronize()
        assert tinter.picture_launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
