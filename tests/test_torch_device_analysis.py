"""The port's encoder analysis stages (turingcodec_tpu_torch.encode.
device_analysis, device="cpu": the same torch code as on the card, with
the kernels' plain versions) against the JAX package's device stages and
the host twins, on tests/test_device_enc.py's inputs and sizes. Every
value is an integer: equality is exact."""
import numpy as np
import pytest
import torch

import turingcodec_tpu.encode.device_analysis as jda
import turingcodec_tpu_torch.encode.device_analysis as tda
from turingcodec_tpu.encode.encoder import Encoder as JaxEncoder
from turingcodec_tpu.encode.encoder import EncoderConfig as JaxConfig


def _seed_inputs():
    rng = np.random.RandomState(3)
    h, w = 96, 144   # non-multiples of 64 exercise the clamped decimation
    orig = rng.randint(0, 256, (h, w)).astype(np.int16)
    ref = np.roll(orig, (3, -5), (0, 1)).astype(np.int16)
    ref[40:60, 40:80] = rng.randint(0, 256, (20, 40))
    return orig, ref


def _dense_inputs():
    rng = np.random.RandomState(5)
    h, w = 112, 176   # non-multiples of 64 exercise the padding
    orig = rng.randint(0, 256, (h, w)).astype(np.int16)
    ref = np.roll(orig, (-7, 9), (0, 1)).astype(np.int16)
    ref[30:70, 50:120] = rng.randint(0, 256, (40, 70))
    return orig, ref


def test_seed_field_matches_jax_and_host():
    from turingcodec_tpu_torch.encode.inter_search import InterPictureEncoder
    orig, ref = _seed_inputs()
    got, wb, hb = tda.seed_field_device(orig, ref, "cpu")
    want, wb_j, hb_j = jda.seed_field_device(orig, ref)
    assert (wb, hb) == (wb_j, hb_j)
    assert got.dtype == np.int32 and got.shape == (hb, wb, 2)
    np.testing.assert_array_equal(got, want)
    enc = InterPictureEncoder.__new__(InterPictureEncoder)
    enc._lr_seed_cache = {}
    enc.orig = [orig]
    host, wb_h, hb_h = enc._lowres_seed_field(ref)
    assert (wb_h, hb_h) == (wb, hb)
    np.testing.assert_array_equal(got, host)


def test_dense_field_matches_jax_and_native():
    from turingcodec_tpu_torch import native
    orig, ref = _dense_inputs()
    got = tda.analysis_device(orig, ref, "cpu")
    want = jda.analysis_device(orig, ref)
    assert got[3:] == want[3:]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    res = native.dense_analysis(orig, ref, 8)
    assert res is not None, "native core unavailable"
    for g, n in zip(got[:3], res[:3]):
        np.testing.assert_array_equal(g, n)


@pytest.mark.parametrize("bd", [8, 10])
def test_subpel_planes_match_jax_and_host(bd):
    rng = np.random.RandomState(7)
    h, w = 22, 37
    ref = rng.randint(0, 1 << bd, (h, w)).astype(np.int16)
    got = tda.subpel_planes_device(ref, bd, "cpu")
    assert got.dtype == np.int16
    assert got.shape == (15, h + 2 * tda.SP_P, w + 2 * tda.SP_P)
    np.testing.assert_array_equal(got, jda.subpel_planes_device(ref, bd))
    np.testing.assert_array_equal(got, jda.subpel_planes_host(ref, bd))
    np.testing.assert_array_equal(tda.subpel_planes_host(ref, bd), got)


@pytest.fixture(scope="module")
def rank_tables():
    rng = np.random.RandomState(5)
    w, h = 128, 96
    plane = rng.randint(0, 256, (h, w)).astype(np.int16)
    plane[20:60, 30:100] = (np.add.outer(np.arange(40), np.arange(70))
                            % 256)
    zscan = JaxEncoder(JaxConfig(width=w, height=h, qp=32,
                                 rd_candidates=2)).geom.zscan
    return {"port_device": tda.rank_satd_tables_device(plane, zscan, 8,
                                                       True, "cpu"),
            "port_host": tda.rank_satd_tables_host(plane, zscan, 8, True),
            "jax_device": jda.rank_satd_tables_device(plane, zscan, 8, True),
            "jax_host": jda.rank_satd_tables_host(plane, zscan, 8, True)}


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rank_satd_tables_match_jax_and_host(rank_tables, n):
    got = rank_tables["port_device"][n]
    assert got.dtype == np.int32 and got.shape == (96 // n, 128 // n, 35)
    for other in ("port_host", "jax_device", "jax_host"):
        np.testing.assert_array_equal(got, rank_tables[other][n],
                                      err_msg=other)


def test_cuda_without_a_card_raises(monkeypatch):
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tda.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Encoder(EncoderConfig(width=64, height=64, device="cuda"))
    with pytest.raises(RuntimeError):  # the default asks for the card
        EncoderConfig(width=64, height=64)
    assert EncoderConfig(width=64, height=64, device=None).device is None
    assert tda.resolve_device(None) is None
    assert tda.resolve_device("cpu") == torch.device("cpu")


def test_no_lowres_switch_turns_the_stage_off(monkeypatch):
    dev = torch.device("cpu")
    assert tda.device_enc_enabled(dev)
    assert not tda.device_enc_enabled(None)
    monkeypatch.setenv("TC_NO_LOWRES", "1")
    assert not tda.device_enc_enabled(dev)
