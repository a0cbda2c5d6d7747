"""The port's decoder device stages and pipeline on the CPU (device="cpu":
the kernels' plain versions), exact integers throughout.

- deblock_picture_device and sao_picture_device against the JAX package's,
  on plans captured from the port's decode of ms_indep3 (slice gating) and
  vfy_sweep (GOP8 with SAO);
- Decoder(device="cpu") md5-equal to GOLDEN.json (md5s the JAX decoder and
  the reference decoder produced) with the chained pipeline taken;
- MC's launches: one mc_picture call per picture with inter blocks and
  none through device_recon's mc_block_grid; P pictures hand it an empty
  list 1 that no block uses, and the uni/bi combine stays exact where B
  pictures use list 1 in part;
- the staged TURING_TPU_DEVICE_* switches, the envelope counts and the
  device DPB's copies;
- all GOLDEN streams through the port's host path (the corpus oracle of
  tests/test_stream_corpus.py)."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import turingcodec_tpu.ops.deblock as jdeblock
import turingcodec_tpu.ops.sao as jsao
import turingcodec_tpu_torch.decode.device_pipeline as dp
import turingcodec_tpu_torch.decode.picture_recon as picture_recon
import turingcodec_tpu_torch.ops.deblock as tdeblock
import turingcodec_tpu_torch.ops.sao as tsao
from turingcodec_tpu_torch.decode.decoder import Decoder

STREAMS = os.path.join(os.path.dirname(__file__), "streams")
GOLDEN = json.load(open(os.path.join(STREAMS, "GOLDEN.json")))
NAMES = [k for k in GOLDEN if not k.startswith("_")]
SWITCHES = ("TURING_TPU_DEVICE_RECON", "TURING_TPU_DEVICE_DEBLOCK",
            "TURING_TPU_DEVICE_SAO", "TURING_TPU_DEVICE_PIPELINE")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _data(name):
    return open(os.path.join(STREAMS, name), "rb").read()


def _decode(name, device=None):
    """(md5 of the decoded YUV, frames, decoder)."""
    dec = Decoder(device=device)
    md5 = hashlib.md5()
    n = 0
    for f in dec.decode_stream(_data(name)):
        assert f.hash_ok is not False, f"{name}: hash SEI mismatch"
        for p in f.planes:
            md5.update(p.astype("uint8").tobytes())
        n += 1
    return md5.hexdigest(), n, dec


def _capture(name, attr, n_frames):
    """[(plan, geom, planes)] at the host decoder's call of
    picture_recon.<attr> (deblock_picture or sao_picture)."""
    got = []
    orig = getattr(picture_recon, attr)

    def hooked(plan, geom, *planes):
        flat = planes[0] if len(planes) == 1 else planes
        got.append((plan, geom, [p.copy() for p in flat]))
        return orig(plan, geom, *planes)

    setattr(picture_recon, attr, hooked)
    try:
        for i, _f in enumerate(Decoder(device=None).decode_stream(_data(name))):
            if i + 1 >= n_frames:
                break
    finally:
        setattr(picture_recon, attr, orig)
    return got


def test_deblock_matches_jax_multislice():
    pics = _capture("ms_indep3.hevc", "deblock_picture", 3)
    assert len(pics) >= 2
    assert any(len(plan.slice_headers) > 1 for plan, _g, _p in pics)
    for plan, geom, planes in pics:
        want = [p.copy() for p in planes]
        jdeblock.deblock_picture_device(plan, geom, *want)
        got = [p.copy() for p in planes]
        tdeblock.deblock_picture_device(plan, geom, *got, "cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a, b) for a, b in zip(got, planes))


def test_sao_matches_jax_gop8():
    pics = _capture("vfy_sweep.hevc", "sao_picture", 4)
    assert len(pics) >= 3
    for plan, geom, planes in pics:
        want = jsao.sao_picture_device(plan, geom, [p.copy() for p in planes])
        got = tsao.sao_picture_device(plan, geom, planes, "cpu")
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        # pull=False: the same planes, left as tensors on the device
        dev = tsao.sao_picture_device(
            plan, geom, [torch.from_numpy(p) for p in planes], "cpu",
            pull=False)
        for a, b in zip(dev, want):
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", ["smp_g4.hevc", "vfy_sweep.hevc",
                                  "static_test.hevc", "amp_test.hevc",
                                  "ms_indep3.hevc"])
def test_device_pipeline_md5(name):
    dp.pictures = dp.envelope_host = 0
    md5, n, dec = _decode(name, "cpu")
    assert md5 == GOLDEN[name] and dec.hash_failures == 0
    assert dp.pictures == n and dp.envelope_host == 0


def _mc_calls(monkeypatch):
    """Record every mc_picture call of the pipeline's MC as (list 0's and
    list 1's references, blocks predicted from list 0, from list 1, blocks
    predicted), every picture's count of inter blocks as the staged path
    finds them (device_recon._inter_blocks), and any call of device_recon's
    mc_block_grid (the staged path's MC, which the pipeline no longer
    takes)."""
    import turingcodec_tpu_torch.decode.device_recon as trecon
    calls, pics, staged = [], [], []
    fused, stage, block_grid = dp.mc_picture, dp._mc_device, \
        trecon.mc_block_grid

    def fused_hook(planes, refs, inter, ref_idx, mv, bds):
        on = (ref_idx >= 0) & (inter != 0)
        calls.append((len(refs[0]), len(refs[1]), int(on[0].sum()),
                      int(on[1].sum()), int(on.any(0).sum())))
        return fused(planes, refs, inter, ref_idx, mv, bds)

    def stage_hook(plan, ref_lists, planes):
        blocks = trecon._inter_blocks(plan)
        pics.append(0 if blocks is None else len(blocks[0]))
        return stage(plan, ref_lists, planes)

    def block_grid_hook(*a):
        staged.append(a)
        return block_grid(*a)

    monkeypatch.setattr(dp, "mc_picture", fused_hook)
    monkeypatch.setattr(dp, "_mc_device", stage_hook)
    monkeypatch.setattr(trecon, "mc_block_grid", block_grid_hook)
    return calls, pics, staged


@pytest.mark.parametrize("name", ["vfy_hp.hevc", "static_test.hevc"])
def test_p_pictures_make_no_list1_call(name, monkeypatch):
    """P-only streams: one mc_picture call per inter picture, its list 1
    empty and used by no block, none through mc_block_grid, and the md5 of
    the JAX and reference decoders."""
    calls, pics, staged = _mc_calls(monkeypatch)
    md5, _n, dec = _decode(name, "cpu")
    assert md5 == GOLDEN[name] and dec.hash_failures == 0
    inter = [b for b in pics if b]
    assert inter and not staged
    assert [c[4] for c in calls] == inter
    assert all(l0 > 0 and l1 == 0 and u1 == 0 and u0 == b
               for l0, l1, u0, u1, b in calls)


def test_b_pictures_combine_both_lists(monkeypatch):
    """GOP8 with B pictures, some blocks on list 1 only, some on both, some
    on list 0 only: one mc_picture call per picture with inter blocks over
    every block the staged path predicts, and the decode stays
    md5-exact."""
    calls, pics, staged = _mc_calls(monkeypatch)
    md5, _n, dec = _decode("vfy_sweep.hevc", "cpu")
    assert md5 == GOLDEN["vfy_sweep.hevc"] and dec.hash_failures == 0
    assert not staged
    assert [c[4] for c in calls] == [b for b in pics if b]
    partial = [c for c in calls if 0 < c[3] < c[4] and 0 < c[2] < c[4]]
    assert partial, calls
    assert any(c[1] > 0 for c in calls)


def test_weighted_prediction_stays_on_the_host_and_is_counted():
    dp.pictures = dp.envelope_host = 0
    md5, n, _dec = _decode("vfy_wp.hevc", "cpu")
    assert md5 == GOLDEN["vfy_wp.hevc"]
    assert dp.envelope_host > 0 and dp.pictures + dp.envelope_host == n


@pytest.mark.parametrize("stage,module,fn", [
    ("RECON", "turingcodec_tpu_torch.decode.device_recon",
     "reconstruct_inter_device"),
    ("DEBLOCK", "turingcodec_tpu_torch.ops.deblock",
     "deblock_picture_device"),
    ("SAO", "turingcodec_tpu_torch.ops.sao", "sao_picture_device")])
def test_staged_switch_takes_its_stage(stage, module, fn, monkeypatch):
    import importlib
    mod = importlib.import_module(module)
    calls = []
    real = getattr(mod, fn)
    monkeypatch.setattr(mod, fn, lambda *a: calls.append(1) or real(*a))
    # a switch with no device changes nothing
    monkeypatch.setenv(f"TURING_TPU_DEVICE_{stage}", "1")
    assert _decode("vfy_sweep.hevc")[0] == GOLDEN["vfy_sweep.hevc"]
    assert not calls
    # with a device, the switch selects the staged stage over the pipeline
    dp.pictures = 0
    assert _decode("vfy_sweep.hevc", "cpu")[0] == GOLDEN["vfy_sweep.hevc"]
    assert calls and dp.pictures == 0


def test_transform_skip_inter_residuals(monkeypatch):
    """No GOLDEN stream has transform skip in an inter CU: encode one with
    the port (--tskip tries it on 4x4 chroma TBs of 8x8 inter CUs) and
    hold the pipeline's decode against the JAX package's host decode."""
    from turingcodec_tpu.decode.decoder import decode_to_yuv
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    from turingcodec_tpu_torch.ops.transform import TU_KIND, tu_fields
    rng = np.random.RandomState(5)
    base = rng.randint(0, 256, (80, 80)).astype(np.int16)
    enc = Encoder(EncoderConfig(width=64, height=64, qp=27, rd_candidates=2,
                                tskip=True, sao=False, device=None))
    out = [enc.headers()]
    for i in range(3):
        f = [base[i:i + 64, 2 * i:2 * i + 64].copy(), base[:32, :32].copy(),
             base[8:40, :32].copy()]
        out += [nal for (_i, nal, _r) in enc.push_frame(f)]
    out += [nal for (_i, nal, _r) in enc.flush()]
    stream = b"".join(out)
    tables = []
    real = dp._residual_table
    monkeypatch.setattr(dp, "_residual_table",
                        lambda plan: tables.append(real(plan)) or tables[-1])
    dec = Decoder(device="cpu")
    md5 = hashlib.md5()
    for f in dec.decode_stream(stream):
        for p in f.planes:
            md5.update(p.astype("uint8").tobytes())
    assert dec.hash_failures == 0
    assert any((tu_fields(t[:, TU_KIND])[2] == 1).any() for t in tables)
    assert md5.hexdigest() == decode_to_yuv(stream)[0]


def test_cuda_without_a_card_raises(monkeypatch):
    """"cuda", also as the default, raises without a card: the decoder
    never falls back to the host."""
    from turingcodec_tpu_torch.decode.decoder import decode_to_yuv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Decoder(device="cuda"), Decoder,
                 lambda: decode_to_yuv(_data("static_test.hevc"),
                                       device="cuda"),
                 lambda: decode_to_yuv(_data("static_test.hevc"))):
        with pytest.raises(RuntimeError):
            make()


def test_device_dpb_holds_copies():
    """The device DPB never aliases the host planes the decoder hands out:
    on device="cpu" a view would let host writes corrupt a reference."""
    dp._DEV_DPB.clear()
    frames = list(Decoder(device="cpu").decode_stream(
        _data("smp_g4.hevc")))
    assert dp._DEV_DPB
    for host, dev in dp._DEV_DPB.values():
        for h, d in zip(host, dev):
            assert d.dtype == torch.int16 and d.device.type == "cpu"
            assert not np.shares_memory(h, d.numpy())
            np.testing.assert_array_equal(h, d.numpy())
    assert frames


@pytest.mark.parametrize("name", NAMES)
def test_corpus_stream_host_path(name):
    md5, n, dec = _decode(name)
    assert n > 0 and not dec.violations, (name, dec.violations)
    assert md5 == GOLDEN[name], name
