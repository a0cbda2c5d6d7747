"""CPU tests of the benchmark's parts: the content pool, the frozen bound
counts, the statistics and trace arithmetic, the import guard and the
result line. Run from the repository root:

    python -m pytest hevc_bench/tests
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hevc_bench import content, harness
from hevc_bench.bounds import (deblock, dense_me, dequant_idct, mc_block_grid,
                               peaks, rank_satd, sao, seed_field,
                               subpel_planes)
from hevc_bench.reference import stream as ref_stream

MOTION = harness.load_json("hevc_bench/traffic/motion.json")


def small(params, frames=4):
    return dict(params, pool_frames=frames)


def test_pool_same_seed_same_frames():
    a = content.make_pool(small(MOTION), 96, 64, 2**40 + 3, "cpu")
    b = content.make_pool(small(MOTION), 96, 64, 2**40 + 3, "cpu")
    assert len(a) == 4
    for fa, fb in zip(a, b):
        assert [p.shape for p in fa] == [(64, 96), (32, 48), (32, 48)]
        assert all(p.dtype == np.int16 for p in fa)
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))


def test_pool_other_seed_other_frames():
    a = content.make_pool(small(MOTION), 96, 64, 11, "cpu")
    b = content.make_pool(small(MOTION), 96, 64, 12, "cpu")
    assert not np.array_equal(a[0][0], b[0][0])


def test_pool_samples_in_range_and_moving():
    a = content.make_pool(small(MOTION), 96, 64, 5, "cpu")
    for f in a:
        for p in f:
            assert p.min() >= 0 and p.max() <= 255
    assert np.abs(a[1][0].astype(int) - a[0][0]).mean() > 1


def test_static_pool_has_still_background():
    static = harness.load_json("hevc_bench/traffic/static.json")
    a = content.make_pool(dict(static, noise_sigma=0.0, pool_frames=3),
                          256, 128, 9, "cpu")
    # one object of 5% moves at most 2 samples a frame: most samples stay
    same = (a[1][0] == a[0][0]).mean()
    assert same > 0.85


def test_play_order_reverses_without_a_cut():
    order = content.play_order(4, 12)
    assert order == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1]
    assert all(abs(a - b) == 1 for a, b in zip(order, order[1:]))


def test_peaks_pick_the_larger_side():
    s, side = peaks.bound(3.35e12, 0)
    assert s == pytest.approx(1.0) and side == "bytes"
    s, side = peaks.bound(0, 132 * 64 * 1.98e9)
    assert s == pytest.approx(1.0) and side == "operations"


def test_seed_bound_by_hand():
    # a 64x64 pair: 4x4 blocks; quarter-res 16x16, half-res 32x32
    b = 16
    ops = b * (289 * 16 + 25 * 64) + 2 * (15 * 256 + 3 * 1024) / 2
    nbytes = 4 * 64 * 64 + 8 * b
    want = max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT32_OPS_PER_S)
    assert seed_field.seed_bound(1, 64, 64)[0] == pytest.approx(want)
    x = torch.zeros((2, 64, 64), dtype=torch.int16)
    assert seed_field.bound((x, x), {})[0] == pytest.approx(
        seed_field.seed_bound(2, 64, 64)[0])


def test_dense_bound_by_hand():
    b = 12
    ops = 289 * 256 * b
    got = dense_me.dense_bound(b, 1000, True)[0]
    want = max((2000 + 20 * b + 4 * 289 * b) / peaks.HBM_BYTES_PER_S,
               ops / peaks.INT32_OPS_PER_S)
    assert got == pytest.approx(want)
    o = torch.zeros((48, 64), dtype=torch.int16)
    args = (o, o, None, 64, 48, 4, 3, True)
    assert dense_me.bound(args, {"bit_depth": 8})[0] == pytest.approx(
        dense_me.dense_bound(12, 48 * 64 * 2, True)[0])


def test_subpel_bound_by_hand():
    h, w = 8, 16
    ph, pw = 64, 72
    ops = 24 * (ph + 7) * pw + 12 * 8 * ph * pw
    nbytes = 2 * h * w + 30 * ph * pw
    want = max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT32_OPS_PER_S)
    assert subpel_planes.subpel_bound(h, w)[0] == pytest.approx(want)


def test_rank_ops_by_hand():
    # one 4x4 block at 8 bits: packed butterflies, 4 adds a pass
    assert rank_satd.rank_ops(4, 4, 8, (4,)) == int(
        16 * (99 + 5 + 105 + 35 * 4 / 2))
    # one 8x8 block at 10 bits: unpacked, 6 adds a pass
    assert rank_satd.rank_ops(8, 8, 10, (8,)) == int(
        64 * (99 + 5 + 105 + 35 * 6))
    p = torch.zeros((8, 8), dtype=torch.int16)
    assert rank_satd.bound((p, None, 8, True), {})[0] == pytest.approx(
        rank_satd.rank_bound(8, 8, 8, [4, 8])[0])


def test_idct_ops_by_hand():
    assert dequant_idct.idct_ops(2) == 4
    assert dequant_idct.idct_ops(4) == 4 + 4 + 4
    assert dequant_idct.idct_ops(8) == 16 + 12 + 8


def test_dequant_bound_by_hand():
    # two TUs: a 4x4 DCT of luma and an 8x8 transform skip (mode 1)
    kind = np.array([0 | (2 << 2), 1 | (3 << 2)])
    table = np.zeros((2, 4), np.int32)
    table[:, dequant_idct.TU_KIND] = kind
    samples = 16 + 64
    ops = samples + 2 * 4 * dequant_idct.idct_ops(4)
    want = max((6 * samples + 32) / peaks.HBM_BYTES_PER_S,
               ops / peaks.INT32_OPS_PER_S)
    assert dequant_idct.bound((None, None, table, None), {})[0] == \
        pytest.approx(want)


def test_mc_bound_by_hand():
    # one list, one component, two 8x8 blocks from plane 0: one full-pel,
    # one with a horizontal phase (8 taps)
    plane = torch.zeros((1, 32, 32), dtype=torch.int16)
    planes = [[plane]]
    sel = torch.zeros((1, 2), dtype=torch.int32)
    xf = torch.tensor([[0, 1]])
    yf = torch.tensor([[0, 0]])
    args = (planes, sel, None, None, xf, yf, 8, 8, 8)
    nbytes = 5 * 4 * 2 + 2 * 64 * 4 + plane[0].nbytes
    ops = 64 * 8
    want = max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT32_OPS_PER_S)
    assert mc_block_grid.bound(args, {})[0] == pytest.approx(want)


def test_loop_filter_bounds_by_hand():
    y = torch.zeros((1, 16, 32), dtype=torch.int16)
    c = torch.zeros((1, 8, 16), dtype=torch.int16)
    m = torch.zeros(10, dtype=torch.int32)
    segs = (3 * 4 + 1 * 8)
    nbytes = 2 * (y.nbytes + 2 * c.nbytes) + m.nbytes + m.nbytes
    want = max(nbytes / peaks.HBM_BYTES_PER_S,
               20 * segs / peaks.INT32_OPS_PER_S)
    assert deblock.bound((y, c, c, (m,), (m,)), {})[0] == \
        pytest.approx(want)
    args = ([y, c, c], 64, 8, 8, m, m)
    want = max((2 * (y.nbytes + 2 * c.nbytes) + 2 * m.nbytes)
               / peaks.HBM_BYTES_PER_S,
               10 * (512 + 2 * 128) / peaks.INT32_OPS_PER_S)
    assert sao.bound(args, {})[0] == pytest.approx(want)


def test_percentile_matches_numpy():
    rng = np.random.default_rng(1)
    v = list(rng.exponential(size=501))
    for q in (50, 95, 99):
        assert harness.percentile(v, q) == pytest.approx(
            float(np.percentile(v, q)))
    assert harness.percentile([3.0], 95) == 3.0


def test_union_seconds():
    assert harness.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert harness.union_seconds([]) == 0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_read_trace_busy_idle_and_gaps():
    events = [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "enc.picture", 0, 800),
        _ev("user_annotation", "enc.analysis", 0, 300),
        _ev("kernel", "void seed_field_kernel(short)", 100, 50),
        _ev("kernel", "void dense_me_kernel<int>(int)", 120, 100),
        _ev("gpu_memcpy", "Memcpy DtoH", 400, 20),
        _ev("cpu_op", "aten::add", 10, 5),
    ]
    r = harness.read_trace(events, 0.001)
    assert r["busy_s"] == pytest.approx(140e-6)
    assert r["window_s"] == 0.001
    gaps = dict((k, v) for k, v in r["idle_gaps"])
    # 0-100 and 220-300 in the analysis, 300-400 and 420-800 in the
    # picture outside it, 800-1000 in the window alone
    assert gaps["enc.analysis"] == pytest.approx(180e-6)
    assert gaps["enc.picture"] == pytest.approx(480e-6)
    assert gaps["bench.window"] == pytest.approx(200e-6)
    assert r["device_ops"][0][0].startswith("void dense_me_kernel")


def test_roofline_and_idle_shares():
    run = harness.Run({}, {}, {}, 0, 1, True, torch.device("cpu"))
    assert harness.roofline_share(run, ["seed_field"]) is None
    run.profile = {"kernels": {"void seed_field_kernel(x)": (2e-6, 1),
                               "void dense_me_kernel<f>(y)": (6e-6, 2)},
                   "bound_s": {"seed_field_kernel": 1e-6,
                               "dense_me_kernel": 3e-6},
                   "busy_s": 0.25, "window_s": 1.0}
    assert harness.roofline_share(run, ["seed_field", "dense_me"]) == \
        pytest.approx(50.0)
    assert harness.roofline_share(run, ["rank_satd"]) is None
    assert harness.idle_share(run) == pytest.approx(75.0)


def test_guard_compares_whole_top_level_names():
    ok = ["turingcodec_tpu_torch", "turingcodec_tpu_torch.x", "jaxtyping",
          "numpy", "flaxen"]
    assert harness.forbidden_modules(ok) == []
    bad = ["turingcodec_tpu.x", "turingcodec_tpu", "jax", "jaxlib.xla",
           "flax.linen"]
    assert harness.forbidden_modules(ok + bad) == sorted(bad)


def test_run_refuses_without_a_card():
    p = subprocess.run(
        [sys.executable, "-m", "hevc_bench.run", "--workload",
         "enc-ldp1080-motion", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=harness.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_stream_md5_reader_round_trip():
    planes = [np.full((4, 8), 7, np.int16), np.arange(8).reshape(2, 4),
              np.zeros((2, 4), np.int16)]
    md5 = ref_stream.planes_md5(planes)
    payload = bytes([0]) + b"".join(md5)
    # a prefix SEI with the hash, 00 00 0x bytes escaped by 03
    rbsp = bytes([132, len(payload)]) + payload + b"\x80"
    body = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            body.append(3)
            zeros = 0
        body.append(b)
        zeros = zeros + 1 if b == 0 else 0
    nal = bytes([39 << 1, 1]) + bytes(body)
    data = b"\x00\x00\x00\x01" + nal + b"\x00\x00\x01" + bytes([1 << 1, 1])
    assert ref_stream.picture_md5s(data) == [md5]


def test_references_import_nothing_of_the_port():
    code = ("import sys\n"
            "from hevc_bench.reference import analysis, decode, distortion,"
            " stream\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('turingcodec_tpu_torch', 'turingcodec_tpu', 'jax')]\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]


@pytest.mark.parametrize("value,qp,want", [
    (100, 4, 0.0),     # step 1: every coefficient exact
    (100, 28, 0.0),    # step 16: the DC, 800, is 50 steps
    (101, 28, 1.0),    # DC 808 is 50.5 steps: 50 kept, one level short
    (102, 28, 0.0),    # DC 816 is 51 steps
])
def test_anchor_by_hand(value, qp, want):
    from hevc_bench.reference import distortion
    flat = np.full((16, 24), value, np.int16)
    assert distortion.anchor_sse(flat, qp) == pytest.approx(
        want * flat.size, abs=1e-6)
    assert distortion.luma_sse(flat + 2, flat) == 4 * flat.size


def test_benchmark_file_names_its_pieces():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in spec["workloads"]:
        assert w["chips"] == 1
        harness.cell_inputs(spec, w["name"])
        harness.driver_for(w["name"])
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "-m", "hevc_bench.run", "--workload",
         "enc-ldp1080-motion", "--seed", "4000000001", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
