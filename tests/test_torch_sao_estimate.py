"""SAO estimation split into a gather of each CTB's statistics and the
raster-order decision over them (native/enc_core.cpp tc_sao_gather,
tc_sao_decide; ops/sao_stats.py), on the CPU.

The plain torch statistics (the CUDA kernel's plain version) against the
native gather, CTB by CTB and component by component; the split path
(plain statistics, then tc_sao_decide) against the JAX package's
estimate_sao on one slice, several slices and tiles, and the host's
row-banded call sequence likewise; and a small random-access encode whose
SAO statistics come from the device path on the CPU against the host path,
byte for byte.
"""
from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from turingcodec_tpu.encode import sao_search as jax_sao
from turingcodec_tpu_torch import native
from turingcodec_tpu_torch.encode import sao_search
from turingcodec_tpu_torch.ops import sao_stats as ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(rng, h, w, bd):
    """Source planes (a level per 16x16 block under a stepped texture
    with ties) and deblocked planes off them, [y, cb, cr] int16, the
    chroma half the luma's sides: clean in the left 64 luma columns,
    elsewhere per 8x8 block clean, noisy (edge offsets pay) or shifted
    (band offsets pay), with the extremes, so that every edge category,
    candidate type and merge occurs."""
    top = (1 << bd) - 1
    unit = 1 << (bd - 8)
    deb, org = [], []
    for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        y, x = np.mgrid[:hh, :ww]
        level = rng.integers(16, 216, (-(-hh // 16), -(-ww // 16))) * unit
        o = (level.repeat(16, 0).repeat(16, 1)[:hh, :ww]
             + (x + 2 * y) // 3 % 5 * unit)
        kind = rng.integers(0, 3, (-(-hh // 8), -(-ww // 8)))
        kind = kind.repeat(8, 0).repeat(8, 1)[:hh, :ww]
        kind[:, :ww * 64 // w] = 0      # a clean column of CTBs: off
        noise = rng.integers(-3, 4, (hh, ww)) * unit
        r = o + np.where(kind == 1, noise, 0) + np.where(kind == 2, -4 * unit,
                                                         0)
        r[(rng.random((hh, ww)) < 0.01) & (kind > 0)] = top
        r[(rng.random((hh, ww)) < 0.01) & (kind > 0)] = 0
        deb.append(np.clip(r, 0, top).astype(np.int16))
        org.append(o.astype(np.int16))
    return org, deb


def _native_gather(org, deb, ctb, bd, cy0, cy1):
    lib = native.get_lib()
    h, w = deb[0].shape
    wc = -(-w // ctb)
    out = np.zeros((cy1 - cy0, wc, 3, ss.N_STATS), np.int32)
    optrs = np.array([p.ctypes.data for p in org], np.int64)
    rptrs = np.array([p.ctypes.data for p in deb], np.int64)
    lib.tc_sao_gather(optrs.ctypes.data, rptrs.ctypes.data, wc, ctb, w, h,
                      bd, bd, cy0, cy1, out.ctypes.data)
    return out


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("ctb", [16, 32, 64])
@pytest.mark.parametrize("h,w", [(136, 200), (72, 104)])
def test_plain_statistics_are_the_native_gather(h, w, ctb, bd):
    assert native.get_lib() is not None
    org, deb = _planes(np.random.default_rng(ctb * 100 + bd), h, w, bd)
    got = ss.sao_stats([torch.from_numpy(p) for p in org],
                       [torch.from_numpy(p) for p in deb], ctb, bd, bd)
    hc = -(-h // ctb)
    want = _native_gather(org, deb, ctb, bd, 0, hc)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    # a band of rows gathers those rows alone
    assert np.array_equal(_native_gather(org, deb, ctb, bd, 1, 2), want[1:2])
    # every edge category and many bands are populated
    assert (want[..., :16].sum(axis=(0, 1, 2)) > 0).all()


def _layout(kind, hc, wc):
    """(slice_idx, tile_id) per CTB: one slice; slices starting mid-row;
    a 2x2 tile grid with a slice per tile."""
    slice_idx = np.zeros((hc, wc), np.int32)
    tile_id = np.zeros((hc, wc), np.int32)
    if kind == "slices":
        flat = slice_idx.reshape(-1)
        for start in (wc // 2, wc + wc // 3 + 1, 3 * wc - 1):
            flat[start:] += 1
    elif kind == "tiles":
        tile_id[:, wc // 2:] = 1
        tile_id[hc // 2:] += 2
        slice_idx[:] = tile_id
    return slice_idx, tile_id


def _plan(h, w, ctb, bd, slice_idx):
    hc, wc = slice_idx.shape
    sps = SimpleNamespace(
        pic_width_in_ctbs_y=wc, pic_height_in_ctbs_y=hc, ctb_size_y=ctb,
        pic_width_in_luma_samples=w, pic_height_in_luma_samples=h,
        bit_depth_y=bd, bit_depth_c=bd, chroma_array_type=1)
    return SimpleNamespace(
        sps=sps, slice_idx=slice_idx.copy(),
        sao_type=np.zeros((hc, wc, 3), np.uint8),
        sao_class=np.zeros((hc, wc, 3), np.uint8),
        sao_offsets=np.zeros((hc, wc, 3, 4), np.int8),
        sao_merge=np.zeros((hc, wc), np.uint8))


def _params(plan):
    return [plan.sao_type, plan.sao_class, plan.sao_offsets, plan.sao_merge]


@pytest.mark.parametrize("path", ["device_cpu", "host_banded"])
@pytest.mark.parametrize("kind", ["one_slice", "slices", "tiles"])
@pytest.mark.parametrize("ctb,bd", [(32, 8), (16, 10), (64, 8)])
def test_split_path_is_the_jax_estimate(kind, path, ctb, bd, monkeypatch):
    h, w = 200, 328
    hc, wc = -(-h // ctb), -(-w // ctb)
    org, deb = _planes(np.random.default_rng(ctb + bd), h, w, bd)
    slice_idx, tile_id = _layout(kind, hc, wc)
    geom = SimpleNamespace(tile_id=tile_id)
    lam = 0.57 * 2 ** ((30 - 12) / 3.0) * (1 << (2 * (bd - 8)))

    want = _plan(h, w, ctb, bd, slice_idx)
    with monkeypatch.context() as mp:
        # the JAX package's pure-Python estimate: an oracle of its own
        mp.setenv("TURING_TPU_NO_NATIVE_ENC", "1")
        jax_sao.estimate_sao(want, geom, org, deb, lam)

    got = _plan(h, w, ctb, bd, slice_idx)
    if path == "device_cpu":
        calls = []
        gather = ss.sao_stats
        monkeypatch.setattr(ss, "sao_stats",
                            lambda *a: calls.append(1) or gather(*a))
        sao_search.estimate_sao(got, geom, org, deb, lam, device="cpu")
        assert calls == [1]
    else:
        for cy in range(hc):
            sao_search.estimate_sao(got, geom, org, deb, lam, cy, cy + 1,
                                    device="cpu")
    for a, b in zip(_params(got), _params(want)):
        assert np.array_equal(a, b)
    # the decisions use every type, and merge
    assert {0, 1, 2} <= set(np.unique(want.sao_type))
    assert want.sao_merge.any()


def _ra_encode(device, frames, monkeypatch):
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    with open(os.path.join(ROOT, "hevc_bench", "configs",
                           "ra_fast_1080p_one_idr.json")) as f:
        cfg = json.load(f)["encoder"]
    h, w = frames[0][0].shape
    calls = []
    gather = sao_search._estimate_sao_device
    monkeypatch.setattr(sao_search, "_estimate_sao_device",
                        lambda *a: calls.append(1) or gather(*a))
    enc = Encoder(EncoderConfig(width=w, height=h, bit_depth=8,
                                device=device, **cfg))
    out = []
    for fr in frames:
        out += enc.push_frame([p.copy() for p in fr])
    out += enc.flush()
    monkeypatch.undo()
    return enc.headers() + b"".join(nal for _i, nal, _r in out), len(calls)


def test_ra_encode_with_device_statistics_is_the_host_encode(monkeypatch):
    """384x256, GOP 8 with SAO on every picture (frame-parallel pairs):
    the statistics of every picture from the device path on the CPU, the
    same bytes as the host path."""
    from hevc_bench.content import make_pool
    with open(os.path.join(ROOT, "hevc_bench", "traffic",
                           "motion.json")) as f:
        traffic = json.load(f)
    pool = make_pool(traffic, 384, 256, 2**33 + 5, torch.device("cpu"))
    frames = [[np.array(p) for p in pool[i]] for i in range(9)]
    dev_stream, dev_calls = _ra_encode("cpu", frames, monkeypatch)
    host_stream, host_calls = _ra_encode(None, frames, monkeypatch)
    assert (dev_calls, host_calls) == (9, 0)
    assert dev_stream == host_stream
