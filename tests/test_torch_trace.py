"""The port's trace (turingcodec_tpu_torch/utils/profiler.py) on the CPU:
span nesting and pictures, the off path's cost, the spans as
torch.profiler annotations, the CTU walk's thread timers, the transfer
byte counters, and the benchmark's metrics that read the trace."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hevc_bench import harness
from turingcodec_tpu_torch import native
from turingcodec_tpu_torch.decode import device_pipeline as dp
from turingcodec_tpu_torch.decode.decoder import Decoder
from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
from turingcodec_tpu_torch.ops import kernel_build
from turingcodec_tpu_torch.utils import profiler
from turingcodec_tpu_torch.utils.profiler import TRACE

STREAMS = os.path.join(os.path.dirname(__file__), "streams")
SEED = 2**33 + 19
NEW_METRICS = {
    "enc-ldp1080-motion": ("enc.ctu_walk_ms", "enc.wpp_occupancy",
                           "enc.inter_search_ms", "enc.serial_ms",
                           "enc.upload_mb", "enc.wpp_switches",
                           "enc.subpel_install_mb"),
    "enc-ra1080-motion": ("enc.bi_search_ms", "enc.sao_search_ms",
                          "enc.batch_occupancy", "enc.subpel_install_mb"),
    "dec-ra1080-motion": ("dec.parse_ms", "dec.stage_host_ms",
                          "dec.transfer_ms", "dec.hash_ms", "dec.upload_mb"),
}


@pytest.fixture(autouse=True)
def trace_off():
    """Each test starts with recording off and no records, and ends with
    recording off."""
    TRACE.forced = False
    TRACE.root("off").end()
    TRACE.clear()
    yield
    TRACE.forced = False
    TRACE.root("off").end()


def _frames(w, h, n, seed=1):
    """n 4:2:0 frames of a textured picture moving by a sample a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + n, w + n)).astype(np.int16)
    c = np.full((h // 2, w // 2), 128, np.int16)
    return [[np.ascontiguousarray(base[i:i + h, i:i + w]), c.copy(),
             c.copy()] for i in range(n)]


def _encode(w, h, n):
    enc = Encoder(EncoderConfig(width=w, height=h, qp=32, rd_candidates=1,
                                search_range=32, gop_m=1, sao=False,
                                device="cpu"))
    out = []
    for f in _frames(w, h, n):
        out += enc.push_frame(f)
    return enc.headers() + b"".join(nal for _i, nal, _r in out)


def _ra_encode(w, h, n):
    """A random-access encode (GOP 8, SAO) of n frames, with the
    frame-parallel batches of two pictures that the hierarchy allows."""
    enc = Encoder(EncoderConfig(width=w, height=h, qp=32, rd_candidates=1,
                                search_range=32, gop_m=8, sao=True,
                                device="cpu"))
    out = []
    for f in _frames(w, h, n):
        out += enc.push_frame(f)
    return out + enc.flush()


def _decode(n=3):
    data = open(os.path.join(STREAMS, "vfy_sweep.hevc"), "rb").read()
    return [f.planes for f in Decoder(device="cpu").decode_stream(
        data, max_frames=n)]


def _children_cover(tr, root_name):
    """Per root span of the name: the share of it its children cover."""
    spans = {s[3]: s for s in tr.spans}
    kids = {}
    for s in tr.spans:
        kids.setdefault(s[4], []).append(s)
    shares = []
    for sid, s in spans.items():
        if s[0] != root_name or s[3] != s[5]:
            continue
        ivs = sorted((max(k[1], s[1]), min(k[2], s[2]))
                     for k in kids.get(sid, ()))
        covered = harness.union_seconds([iv for iv in ivs if iv[1] > iv[0]])
        shares.append(covered / (s[2] - s[1]))
    return shares


def test_nesting_parents_and_pictures():
    TRACE.forced = True
    root = TRACE.root("enc.docket", (4, 4))
    with TRACE.within(root), TRACE.span("enc.prepare"):
        with TRACE.span("enc.fields"):
            TRACE.count("enc.upload.pageable_bytes", 10)
        TRACE.count("enc.upload.pageable_bytes", 5)
    root.end()
    with TRACE.root("dec.finish"):
        TRACE.set_picture(7)
        with TRACE.span("dec.parse"):
            pass
    TRACE.count("outside", 1)
    by = {s[0]: s for s in TRACE.spans}
    assert by["enc.fields"][4] == by["enc.prepare"][3]
    assert by["enc.prepare"][4] == by["enc.docket"][3]
    assert by["enc.docket"][4] is None
    assert by["enc.fields"][5] == by["enc.prepare"][5] \
        == by["enc.docket"][3]
    assert by["dec.parse"][4] == by["dec.parse"][5] == by["dec.finish"][3]
    assert TRACE.pictures == {by["enc.docket"][3]: (4, 4),
                              by["dec.finish"][3]: 7}
    assert TRACE.counters[by["enc.docket"][3]] == {
        "enc.upload.pageable_bytes": 15}
    assert TRACE.counters[None] == {"outside": 1}
    for s in TRACE.spans:
        assert s[1] <= s[2]
    outer, inner = by["enc.prepare"], by["enc.fields"]
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]
    summ = TRACE.summary()
    assert summ["pictures"] == 2
    e = summ["spans"]["enc.prepare"]
    assert e["count"] == 1 and e["self_ns"] == \
        (outer[2] - outer[1]) - (inner[2] - inner[1])
    assert summ["counters"]["enc.upload.pageable_bytes"] == {
        "total": 15, "per_picture": 7.5}
    text = TRACE.report()
    assert "enc.docket" in text and "dec.parse" in text


def test_recording_restarts_afresh():
    TRACE.forced = True
    with TRACE.root("dec.finish"):
        pass
    assert len(TRACE.spans) == 1
    TRACE.forced = False
    with TRACE.root("dec.finish"):
        with TRACE.span("dec.parse"):
            pass
    assert len(TRACE.spans) == 1 and not TRACE.on
    TRACE.forced = True
    with TRACE.root("dec.finish"):
        pass
    assert len(TRACE.spans) == 1


def test_off_reads_no_clock_and_calls_no_profiler(monkeypatch):
    calls = {"clock": 0, "note": 0}
    real = profiler.time

    class Clock:
        @staticmethod
        def perf_counter_ns():
            calls["clock"] += 1
            return real.perf_counter_ns()

    def note(name):
        calls["note"] += 1
        raise AssertionError(f"record_function({name!r}) with recording off")

    def span(*a, **k):
        raise AssertionError("a span made with recording off")

    monkeypatch.setattr(profiler, "time", Clock)
    monkeypatch.setattr(torch.profiler, "record_function", note)
    monkeypatch.setattr(profiler, "_Span", span)
    assert _encode(128, 64, 2)
    assert len(_decode(2)) == 2
    assert calls == {"clock": 0, "note": 0}
    assert TRACE.spans == [] and TRACE.counters == {}


def test_spans_are_profiler_annotations_and_cover_their_roots(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _encode(128, 64, 3)
    enc_spans = {s[0] for s in TRACE.spans}
    enc_cover = _children_cover(TRACE, "enc.docket")
    TRACE.root("off").end()
    with profile(activities=[ProfilerActivity.CPU]) as prof2:
        _decode(3)
    dec_spans = {s[0] for s in TRACE.spans}
    dec_cover = _children_cover(TRACE, "dec.finish")
    assert {"enc.docket", "enc.prepare", "enc.fields", "enc.rank_tables",
            "enc.search", "enc.ctu_walk", "enc.filter", "enc.write",
            "enc.hash", "enc.finalize", "enc.upload",
            "enc.download"} <= enc_spans
    assert {"dec.finish", "dec.parse", "dec.recon", "dec.mc",
            "dec.residual", "dec.intra_host", "dec.deblock", "dec.sao",
            "dec.pull", "dec.upload", "dec.hash", "dec.dpb"} <= dec_spans
    assert len(enc_cover) == 3 and min(enc_cover) >= 0.95
    assert len(dec_cover) >= 3 and min(dec_cover) >= 0.95
    for p, want in ((prof, enc_spans), (prof2, dec_spans)):
        path = str(tmp_path / "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            notes = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"}
        assert want <= notes
        assert all(n.startswith(("enc.", "dec.")) for n in want)
        assert not want & {"bench.window", "enc.picture", "enc.analysis",
                           "dec.picture", "dec.pipeline", "dec.intra"}


def test_wpp_thread_timers_within_the_walk():
    TRACE.forced = True
    native.set_thread_enc_threads(2)
    try:
        _encode(256, 128, 3)
    finally:
        native.set_thread_enc_threads(None)
    walk = TRACE.durations("enc.ctu_walk")
    threads = TRACE.counter("enc.wpp.threads")
    busy = TRACE.counter("enc.wpp.ctu_ns")
    wait = TRACE.counter("enc.wpp.wait_ns")
    assert len(walk) == 3 and set(walk) == set(threads) == set(busy)
    assert set(threads.values()) == {2}
    for r in walk:
        assert 0 < busy[r] + wait.get(r, 0) <= threads[r] * walk[r]
    occupancy = harness.metric_reader("enc.wpp_occupancy")(None)
    assert 0 < occupancy <= 100
    phases = TRACE.summary()["counters"]
    assert phases["enc.native.inter_cu_ns"]["total"] > 0
    assert phases["enc.native.intra_cu_ns"]["total"] > 0


def test_wpp_switches_counted_per_picture():
    """With 2 row threads over 4 CTU rows, rows may move between threads
    at CTU boundaries: every picture counts its moves, at most one per
    CTU, and the occupancy stays a share of the walk."""
    TRACE.forced = True
    native.set_thread_enc_threads(2)
    try:
        _encode(256, 256, 3)
    finally:
        native.set_thread_enc_threads(None)
    walk = TRACE.durations("enc.ctu_walk")
    switches = TRACE.counter("enc.wpp.switches")
    assert len(walk) == 3 and set(switches) == set(walk)
    assert all(0 <= v <= 4 * 4 for v in switches.values())
    assert harness.metric_reader("enc.wpp_switches")(None) \
        == sum(switches.values()) / 3
    occupancy = harness.metric_reader("enc.wpp_occupancy")(None)
    assert 0 < occupancy <= 100


def test_batched_pictures_count_their_own_walks(monkeypatch):
    """Pictures 1 and 3, and 5 and 7, of a GOP-8 encode walk at once, each
    on half of the WPP budget of 4 (2 row threads over 4 CTU rows), the
    others alone on all of it: each picture reads its own walk's thread
    count and busy time, and the pictures' native phase timers take all
    the process timed."""
    monkeypatch.setenv("TURING_TPU_FRAME_THREADS", "2")
    TRACE.forced = True
    native.set_thread_enc_threads(4)
    try:
        _ra_encode(256, 256, 9)
    finally:
        native.set_thread_enc_threads(None)
    assert native.enc_phase_totals() == [0] * 32
    walk = TRACE.durations("enc.ctu_walk")
    threads = TRACE.counter("enc.wpp.threads")
    busy = TRACE.counter("enc.wpp.ctu_ns")
    pocs = {r: TRACE.pictures[r][0] for r in walk}
    assert sorted(pocs.values()) == list(range(9))
    assert set(threads) == set(busy) == set(walk)
    for r, poc in pocs.items():
        assert threads[r] == (2 if poc in (1, 3, 5, 7) else 4), poc
        assert 0 < busy[r] <= threads[r] * walk[r], poc
        phase = "enc.native.inter_cu_ns" if poc else "enc.native.intra_cu_ns"
        assert TRACE.counters[r][phase] > 0, poc
    # IDR, 8, 4, 2, (1, 3), 6, (5, 7): each batch shares the budget
    batches = TRACE.durations("enc.batch")
    assert sorted(TRACE.counter("enc.batch.pictures").values()) == \
        [1] * 5 + [2] * 2
    assert set(TRACE.counter("enc.batch.threads").values()) == {4}
    assert set(TRACE.counter("enc.batch.pictures")) == set(batches)
    assert TRACE.summary()["pictures"] == 9
    occupancy = harness.metric_reader("enc.batch_occupancy")(None)
    assert occupancy == pytest.approx(100.0 * sum(busy.values()) / sum(
        4 * t for t in batches.values()), rel=1e-12)
    assert 0 < occupancy <= 100


def test_b_pictures_time_bi_prediction_sao_and_the_subpel_install():
    TRACE.forced = True
    w, h = 192, 128
    _ra_encode(w, h, 9)
    sao = TRACE.durations("enc.sao_search")
    pics = {r: p[0] for r, p in TRACE.pictures.items()}
    assert sorted(pics.values()) == list(range(9))
    for r, poc in pics.items():
        c = TRACE.counters[r]
        assert sao[r] > 0
        if poc == 0:
            assert "enc.native.bi_refine_ns" not in c
            assert "enc.subpel.install_bytes" not in c
            continue
        assert 0 < c["enc.native.bi_refine_ns"] < c["enc.native.inter_cu_ns"]
        # 15 int16 planes of the reference padded by 28, for each list
        assert c["enc.subpel.install_bytes"] == \
            2 * 15 * (h + 56) * (w + 56) * 2
    summary = TRACE.summary()
    read = harness.metric_reader

    def same(v):  # the readers' order of operations, to the last bit
        return pytest.approx(v, rel=1e-12)

    assert read("enc.bi_search_ms")(None) == same(
        summary["counters"]["enc.native.bi_refine_ns"]["total"] / 9 / 1e6)
    assert read("enc.sao_search_ms")(None) == same(
        summary["spans"]["enc.sao_search"]["total_ns"] / 9 / 1e6)
    assert read("enc.subpel_install_mb")(None) == same(
        8 * 2 * 15 * (h + 56) * (w + 56) * 2 / 9 / 1e6)


def test_overlap_follower_counts_into_its_pictures(monkeypatch):
    """Under inter-picture overlap the follower thread deblocks and
    estimates SAO behind each picture's search: its spans and its native
    loop-filter timer belong to the picture whose rows it filters."""
    monkeypatch.setenv("TURING_TPU_FRAME_THREADS", "4")
    TRACE.forced = True
    enc = Encoder(EncoderConfig(width=192, height=128, qp=32,
                                rd_candidates=1, search_range=32, gop_m=1,
                                sao=True, frame_overlap=True, device=None))
    assert enc._overlap_on()
    for f in _frames(192, 128, 4):
        enc.push_frame(f)
    enc.flush()
    assert native.enc_phase_totals() == [0] * 32
    sao = TRACE.durations("enc.sao_search")
    deblock = TRACE.counter("enc.native.deblock_ns")
    pics = [r for r, p in TRACE.pictures.items() if p is not None]
    assert len(pics) == 4 and set(sao) == set(deblock) == set(pics)
    # one estimate per CTB row (two rows of 64), each inside its picture
    assert all(sum(1 for s in TRACE.spans if s[0] == "enc.sao_search"
                   and s[5] == r) == 2 for r in pics)


# the counters of an LDP encode's inter pictures before frame-parallel
# batches counted apart, and the two since
LDP_COUNTERS = {
    "enc.download.pageable_bytes", "enc.upload.pageable_bytes",
    "enc.native.deblock_ns", "enc.native.dense_me_ns",
    "enc.native.full_pel_ns", "enc.native.inter_cu_ns",
    "enc.native.intra_cu_ns", "enc.native.lowres_ns", "enc.native.snap_ns",
    "enc.native.subpel_ns", "enc.wpp.ctu_ns", "enc.wpp.switches",
    "enc.wpp.threads", "enc.wpp.wait_ns"}
LDP_NEW = {"enc.native.bi_refine_ns", "enc.subpel.install_bytes"}


def test_low_delay_records_what_it_recorded():
    """One picture at a time, as the LDP cell codes: each picture reads
    its own walk as before, and the process keeps nothing unread."""
    TRACE.forced = True
    native.set_thread_enc_threads(2)
    try:
        _encode(256, 128, 3)
    finally:
        native.set_thread_enc_threads(None)
    assert native.enc_phase_totals() == [0] * 32
    pics = {r: p[0] for r, p in TRACE.pictures.items()}
    assert sorted(pics.values()) == [0, 1, 2]
    walk = TRACE.durations("enc.ctu_walk")
    for r, poc in pics.items():
        c = TRACE.counters[r]
        assert c["enc.wpp.threads"] == 2
        assert 0 < c["enc.wpp.ctu_ns"] <= 2 * walk[r]
        if poc:
            assert set(c) - LDP_NEW >= LDP_COUNTERS
            assert set(c) - LDP_COUNTERS <= LDP_NEW | {
                "enc.native.intra_nxn_ns"}
            assert LDP_NEW <= set(c)
    assert sorted(TRACE.counter("enc.batch.pictures").values()) == [1] * 3


def test_byte_counters_equal_the_planes_sizes():
    TRACE.forced = True
    _encode(256, 128, 3)
    plane = 256 * 128 * 2
    ups = TRACE.counter("enc.upload.pageable_bytes")
    pics = sorted(ups, key=lambda r: TRACE.pictures[r][1])
    # the I picture's rank tables take its source plane; an inter picture
    # sends its source and its reference twice each (fields, rank tables,
    # subpel planes)
    assert [ups[r] for r in pics] == [plane, 4 * plane, 4 * plane]
    with TRACE.root("dec.finish"):
        y = np.arange(64 * 32, dtype=np.int16).reshape(32, 64)
        c = np.zeros((16, 32), np.int16)
        dev = [dp._upload(p, "cpu") for p in (y, c, c)]
        dp._pull(dev)
        kernel_build.upload_packed([np.zeros(5, np.int32),
                                    np.zeros(3, np.uint8)], "cpu",
                                   span="dec.upload")
        # without a span name the copy is not the caller's to count
        kernel_build.upload_packed([np.zeros(7, np.int32)], "cpu")
    got = TRACE.counters[TRACE.spans[-1][5]]
    size = y.nbytes + 2 * c.nbytes
    # the packed upload sends each array at a 16-byte offset: 32 + 16
    assert got == {"dec.upload.pageable_bytes": size + 48,
                   "dec.pull.pageable_bytes": size}


def test_fused_mc_counted_once_per_picture_with_inter_blocks(monkeypatch):
    """dec.mc.fused: once in each pipeline picture whose MC took the one
    mc_picture launch (a picture with inter blocks, as the staged path's
    device_recon._inter_blocks finds them), in no other picture."""
    from turingcodec_tpu_torch.decode import device_recon
    inter = []
    stage = dp._mc_device

    def hook(plan, ref_lists, planes):
        inter.append(device_recon._inter_blocks(plan) is not None)
        return stage(plan, ref_lists, planes)

    monkeypatch.setattr(dp, "_mc_device", hook)
    TRACE.forced = True
    before = dp.pictures
    _decode(5)
    roots = {s[5] for s in TRACE.spans if s[0] == "dec.finish"}
    fused = TRACE.counter("dec.mc.fused")
    assert any(inter) and not all(inter)
    assert len(roots) == len(inter) == dp.pictures - before
    assert set(fused) <= roots
    assert list(fused.values()) == [1] * sum(inter)


# one traced run of each cell at 128x64 on the CPU, in a child process:
# the harness refuses to run where the JAX package is loaded, as it is in
# this test process
CELLS = """
import json, sys
from hevc_bench import harness
from hevc_bench.drivers import dec
dec.CACHE = sys.argv[1]
spec = harness.load_spec()
for workload in sys.argv[2:]:
    cfg = dict(harness.cell_inputs(spec, workload)[1], width=128, height=64)
    if "stream_pictures" in cfg:
        cfg["stream_pictures"] = 9
    result, _info, _lines = harness.execute(
        workload, %d, 1.0, True, "cpu", config=cfg, stage_seconds=1.0)
    print(json.dumps([workload, result]))
""" % SEED


def test_traced_cells_read_every_new_metric(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    p = subprocess.run([sys.executable, "-c", CELLS, str(tmp_path)]
                       + list(NEW_METRICS), cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    results = dict(json.loads(line) for line in p.stdout.splitlines()
                   if line.startswith("["))
    assert set(results) == set(NEW_METRICS)
    for workload, names in NEW_METRICS.items():
        result = results[workload]
        for n in names:
            v = result["metrics"][n]["value"]
            assert isinstance(v, float) and v >= 0, (n, v)
        labels = {g[0] for g in result["breakdown"]["idle_gaps"]}
        prefix = workload.split("-")[0] + "."
        assert any(g.startswith(prefix) and g not in (
            "enc.picture", "enc.analysis", "dec.picture", "dec.pipeline",
            "dec.intra") for g in labels), labels
