"""The state the port carries over from the JAX package. The codec has no
trained weights: its state is the encoder configuration and the constant
tables, which must be equal element for element."""
import dataclasses

import numpy as np
import pytest

import turingcodec_tpu.cabac.rate as jrate
import turingcodec_tpu.cabac.tables as jcabac
import turingcodec_tpu.hevc.tables as jhevc
import turingcodec_tpu_torch.cabac.rate as trate
import turingcodec_tpu_torch.cabac.tables as tcabac
import turingcodec_tpu_torch.hevc.tables as thevc
from turingcodec_tpu.encode.encoder import EncoderConfig as JaxConfig
from turingcodec_tpu_torch.encode.encoder import EncoderConfig

CONFIGS = {
    "default": {},
    "fast_ldp_1080p": dict(width=1920, height=1080, qp=30, rd_candidates=1,
                           search_range=32, gop_m=1, sao=False, rdoq=True,
                           sdh=True),
    "ra_tools": dict(width=128, height=96, qp=32, gop_m=4, rdoq=True,
                     sdh=True, rd_candidates=2, wp_luma=(59, 6, 0),
                     mastering_display=((1, 2), (3, 4), (5, 6), (7, 8), 9,
                                        10), aq_strength=1.0, aq_depth=1),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_carries_over(name):
    jax_cfg = JaxConfig(**CONFIGS[name])
    cfg = EncoderConfig.from_dict(dict(dataclasses.asdict(jax_cfg),
                                       device=None))
    got = dataclasses.asdict(cfg)
    assert got.pop("device") is None
    assert got == dataclasses.asdict(jax_cfg)
    assert cfg == EncoderConfig(**CONFIGS[name], device=None)
    assert cfg.sei_user_data == "turingcodec-tpu"


def test_config_rejects_unknown_fields():
    with pytest.raises(TypeError):
        EncoderConfig.from_dict({"no_such_field": 1})


def _public_tables(mod):
    return sorted(k for k, v in vars(mod).items()
                  if k.isupper() and not callable(v))


def _assert_same(a, b, name):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _assert_same(a[k], b[k], f"{name}[{k}]")
    elif isinstance(a, (list, tuple)) and a and not np.isscalar(a[0]):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{name}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name


@pytest.mark.parametrize("pair", ["hevc/tables", "cabac/tables",
                                  "cabac/rate"])
def test_tables_equal(pair):
    jmod, tmod = {"hevc/tables": (jhevc, thevc),
                  "cabac/tables": (jcabac, tcabac),
                  "cabac/rate": (jrate, trate)}[pair]
    names = _public_tables(jmod)
    assert names and names == _public_tables(tmod)
    for k in names:
        _assert_same(getattr(jmod, k), getattr(tmod, k), k)
    if pair == "cabac/rate":
        assert trate.BITS.shape == (128, 2)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_derived_tables_equal(n):
    log2 = n.bit_length() - 1
    np.testing.assert_array_equal(thevc.dct2_matrix(n), jhevc.dct2_matrix(n))
    for idx in range(3):
        np.testing.assert_array_equal(thevc.scan_order(log2, idx),
                                      jhevc.scan_order(log2, idx))
