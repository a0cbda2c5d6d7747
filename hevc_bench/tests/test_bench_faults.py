"""A run on the CPU at a small size, the harness's look for a card left
out, with the timed path broken underneath the window: every fault a
cell can have turns `correct` false, and so does each kind of cell's
control (hevc_bench/control.py). A sound run stays correct.

The faults: a step that returns its state unchanged; half of the work
left out; an answer altered where it is produced; a table that the
encoder and the decoder share altered under both, which only the plain
reference sees. The exchange between chips has no fault here: every cell
takes one chip.
"""
from __future__ import annotations

import numpy as np
import pytest

from hevc_bench import control, harness
from hevc_bench.drivers import dec as dec_driver
from hevc_bench.drivers import enc as enc_driver

DA = "turingcodec_tpu_torch.encode.device_analysis"
DP = "turingcodec_tpu_torch.decode.device_pipeline"
SEED = 2**34 + 77
ENC, DEC = "enc-ldp1080-motion", "dec-ra1080-motion"
EXACT = ("analysis_mismatch", "hash_mismatch", "decode_mismatch",
         "recon_mismatch", "stream_mismatch", "picture_mismatch",
         "order_mismatch")


@pytest.fixture(autouse=True)
def stream_cache(tmp_path, monkeypatch):
    """Each test codes its decode stream afresh, outside the checkout."""
    monkeypatch.setattr(dec_driver, "CACHE", str(tmp_path / "cache"))


def small(workload):
    cfg = harness.cell_inputs(harness.load_spec(), workload)[1]
    cfg = dict(cfg, width=128, height=64)
    if "stream_pictures" in cfg:
        cfg["stream_pictures"] = 9
    return cfg


def run(workload, seconds=1.5):
    result, _info, _lines = harness.execute(
        workload, SEED, seconds, False, "cpu", config=small(workload))
    return result


def break_window(monkeypatch, driver, pairs):
    """The driver's window with `pairs` patched in for its duration."""
    orig = driver.window

    def window(*a, **k):
        with harness.patched(pairs):
            return orig(*a, **k)
    monkeypatch.setattr(driver, "window", window)


def unchanged(orig):
    """A step that returns its first result ever after."""
    first = []

    def f(*a, **k):
        res = orig(*a, **k)
        if not first:
            first.append(res)
        return first[0]
    return f


def altered_seeds(orig):
    def f(*a, **k):
        res = orig(*a, **k)
        sm = np.array(res[0])
        sm[0, 0, 0] += 4
        return (sm,) + tuple(res[1:])
    return f


def half_tables(orig):
    def f(*a, **k):
        res = orig(*a, **k)
        out = {}
        for n, t in res.items():
            t = t.clone()
            t[t.shape[0] // 2:] = 0
            out[n] = t
        return out
    return f


def altered_bytes(orig):
    def f(self, yuv):
        res = orig(self, yuv)
        out = []
        for i, nal, recon in res:
            b = bytearray(nal)
            b[len(b) // 2] ^= 0x10
            out.append((i, bytes(b), recon))
        return out
    return f


def altered_pull(orig):
    def f(planes):
        out = orig(planes)
        out[0][0, 0] ^= 1
        return out
    return f


def half_outputs(orig):
    def f(self, *a, **k):
        for i, fr in enumerate(orig(self, *a, **k)):
            if i % 2 == 0:
                yield fr
    return f


def test_sound_runs_are_correct():
    for w in (ENC, DEC):
        res = run(w)
        assert res["correct"], res["checks"]
        assert all(v["value"] == 0 for n, v in res["checks"].items()
                   if n in EXACT)
        assert res["checks"]["recon_mismatch" if w == DEC
                             else "distortion_db"]["value"] is not None


def test_a_cached_stream_decodes_as_a_fresh_one():
    first = run(DEC)
    again = run(DEC)
    assert first["correct"] and again["correct"], again["checks"]
    assert dec_driver.os.listdir(dec_driver.CACHE)


@pytest.mark.parametrize("name,pairs", [
    ("state unchanged", [((DA, "analysis_device"), unchanged)]),
    ("seed altered", [((DA, "analysis_device"), altered_seeds)]),
    ("half the tables left out", [((DA, "rank_satd_tables"), half_tables)]),
])
def test_encode_faults_fail(monkeypatch, name, pairs):
    break_window(monkeypatch, enc_driver, pairs)
    res = run(ENC)
    assert not res["correct"], (name, res["checks"])


def test_encode_altered_bytes_fail(monkeypatch):
    from turingcodec_tpu_torch.encode.encoder import Encoder
    orig = enc_driver.window

    def window(*a, **k):
        with monkeypatch.context() as m:
            m.setattr(Encoder, "push_frame", altered_bytes(Encoder.push_frame))
            return orig(*a, **k)
    monkeypatch.setattr(enc_driver, "window", window)
    res = run(ENC)
    assert not res["correct"], res["checks"]
    assert res["checks"]["decode_mismatch"]["value"] > 0


def altered_prediction(orig):
    """Motion compensation with one luma prediction sample off by one."""
    def f(*a, **k):
        y, cb, cr = orig(*a, **k)
        y = y.clone()
        y.view(-1)[0] ^= 1
        return y, cb, cr
    return f


def returns_its_input(orig):
    """A stage that hands its input on unchanged."""
    def f(plan, geom, planes, *a, **k):
        return planes
    return f


@pytest.mark.parametrize("name,pairs", [
    ("state unchanged", [((DP, "decode_picture_device"), unchanged)]),
    ("a sample altered", [((DP, "_pull"), altered_pull)]),
    ("deblocking left out", [((DP, "deblock_planes_device"),
                              returns_its_input)]),
    ("a prediction sample altered", [((DP, "_predict"),
                                      altered_prediction)]),
])
def test_decode_faults_fail(monkeypatch, name, pairs):
    break_window(monkeypatch, dec_driver, pairs)
    res = run(DEC)
    assert not res["correct"], (name, res["checks"])
    assert res["checks"]["recon_mismatch"]["value"] > 0


def test_a_shared_table_altered_under_both_sides_fails():
    """The deblocking filter's tC table, which the encoder's and the
    decoder's loop filters both read, altered for the whole run: the
    stream, its MD5 SEI and the decode agree with each other; the plain
    reference does not."""
    from turingcodec_tpu_torch.decode import deblock
    dec_driver.CODE_IN_CHILD = False   # the encoder shares the fault
    saved = deblock.TC_TABLE.copy()
    try:
        deblock.TC_TABLE[18:] += 3
        res = run(DEC)
    finally:
        deblock.TC_TABLE[:] = saved
        dec_driver.CODE_IN_CHILD = True
    checks = {n: v["value"] for n, v in res["checks"].items()}
    assert not res["correct"], checks
    assert checks["recon_mismatch"] > 0
    assert checks["stream_mismatch"] == checks["picture_mismatch"] == 0


def test_decode_half_the_pictures_left_out(monkeypatch):
    from turingcodec_tpu_torch.decode.decoder import Decoder
    orig = dec_driver.window

    def window(*a, **k):
        with monkeypatch.context() as m:
            m.setattr(Decoder, "decode_stream",
                      half_outputs(Decoder.decode_stream))
            return orig(*a, **k)
    monkeypatch.setattr(dec_driver, "window", window)
    res = run(DEC, seconds=3.0)
    assert not res["correct"], res["checks"]
    assert res["checks"]["order_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload,name,fails", [
    (ENC, "seven_bit", "analysis_mismatch"),
    (ENC, "coarser_qp", "distortion_db"),
    (DEC, "seven_bit", "recon_mismatch"),
])
def test_controls_fail(workload, name, fails):
    res, _lines = control.run_control(workload, SEED, 1.5, "cpu",
                                      config=small(workload), control=name)
    assert not res["correct"], res["checks"]
    c = res["checks"][fails]
    assert c["value"] > c["limit"], res["checks"]


def test_result_line_keys():
    for trace in (False, True):
        res, _info, lines = harness.execute(
            ENC, SEED, 1.0, trace, "cpu", config=small(ENC),
            stage_seconds=0.5)
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        if trace:
            keys.append("breakdown")
        assert list(res) == keys + ["checks"]
        assert set(res["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
        assert lines and all(ln.startswith("check ") for ln in lines)
        want = {m["name"] for m in harness.cell_metrics(
            harness.load_spec(), ENC, trace)}
        assert set(res["metrics"]) <= want
        if not trace:
            assert set(res["metrics"]) == want
