"""The port's decoder device stages and pipeline on the CPU (device="cpu":
the kernels' plain versions), exact integers throughout.

- deblock_picture_device and sao_picture_device against the JAX package's,
  on plans captured from the port's decode of ms_indep3 (slice gating) and
  vfy_sweep (GOP8 with SAO);
- Decoder(device="cpu") md5-equal to GOLDEN.json (md5s the JAX decoder and
  the reference decoder produced) with the chained pipeline taken;
- MC's launches: a list no block uses is skipped (P pictures), and the
  uni/bi combine stays exact where B pictures use list 1 in part;
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
    """Record every mc_block_grid call of the pipeline's MC as (lists,
    components, bs), and every _predict call's per-list block usage."""
    import turingcodec_tpu_torch.decode.device_recon as trecon
    calls, pics = [], []
    mc, predict = trecon.mc_block_grid, dp._predict

    def mc_hook(planes, *a):
        calls.append((len(planes), len(planes[0]), a[-3]))
        return mc(planes, *a)

    def predict_hook(plan, by4, bx4, refs, device):
        pics.append([int((plan.ref_idx[lx, by4, bx4] >= 0).sum())
                     for lx in (0, 1)] + [len(by4)])
        return predict(plan, by4, bx4, refs, device)

    monkeypatch.setattr(trecon, "mc_block_grid", mc_hook)
    monkeypatch.setattr(dp, "_predict", predict_hook)
    return calls, pics


@pytest.mark.parametrize("name", ["vfy_hp.hevc", "static_test.hevc"])
def test_p_pictures_make_no_list1_call(name, monkeypatch):
    """P-only streams: one luma and one Cb+Cr launch per picture over list 0
    alone, none for the empty list 1, and the md5 of the JAX and reference
    decoders."""
    calls, pics = _mc_calls(monkeypatch)
    md5, _n, dec = _decode(name, "cpu")
    assert md5 == GOLDEN[name] and dec.hash_failures == 0
    assert pics and all(l1 == 0 for _l0, l1, _b in pics)
    assert calls == [(1, 1, 4), (1, 2, 2)] * len(pics)


def test_b_pictures_combine_both_lists(monkeypatch):
    """GOP8 with B pictures, some blocks on list 1 only, some on both, some
    on list 0 only: one luma and one Cb+Cr launch per picture over the
    lists its blocks use, and the decode stays md5-exact."""
    calls, pics = _mc_calls(monkeypatch)
    md5, _n, dec = _decode("vfy_sweep.hevc", "cpu")
    assert md5 == GOLDEN["vfy_sweep.hevc"] and dec.hash_failures == 0
    partial = [p for p in pics if 0 < p[1] < p[2] and 0 < p[0] < p[2]]
    assert partial, pics
    want = [c for l0, l1, _b in pics
            for c in [((l0 > 0) + (l1 > 0), 1, 4),
                      ((l0 > 0) + (l1 > 0), 2, 2)]]
    assert calls == want


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
