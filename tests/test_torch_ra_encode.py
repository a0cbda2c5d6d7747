"""The port's hierarchical-B random-access encode on the CPU against the
benchmark's plain references: the settings of hevc_bench's
ra_fast_1080p_one_idr configuration (GOP 8 with QP offsets by temporal
layer, SAO, RDOQ and SDH, search 32, WPP, MD5 SEI) at 192x128, with the
analysis stage on the CPU (the kernels' plain versions) and
frame-parallel batches of two.

17 pictures: the IDR and two mini-GOPs coded in the order 8, 4, 2, 1, 3,
6, 5, 7, where 1 and 3, and 5 and 7, code together. Every coded B
picture's returned reconstruction is held to hevc_bench/reference/
decode.py over the picture's parse (MC of both lists and their average,
the inter residuals, deblocking, then SAO), each list's analysis outputs
to hevc_bench/reference/analysis.py, and the stream to the one coded a
picture at a time.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from hevc_bench.content import make_pool
from hevc_bench.reference import analysis as ref_analysis
from hevc_bench.reference import decode as ref_decode
from turingcodec_tpu_torch.decode.decoder import Decoder
from turingcodec_tpu_torch.encode import device_analysis
from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 192, 128, 17
SEED = 2**33 + 23


def _load(*rel):
    with open(os.path.join(ROOT, "hevc_bench", *rel)) as f:
        return json.load(f)


def _frames():
    pool = make_pool(_load("traffic", "motion.json"), W, H, SEED,
                     torch.device("cpu"))
    return [[np.array(p) for p in pool[i]] for i in range(N)]


def _encode(frames, frame_threads, monkeypatch, capture=None):
    """The stream of the 17 pictures, with `frame_threads` pictures in
    flight; `capture` (a dict) gets each picture's pre-loop-filter planes,
    returned reconstruction and encoding thread by POC, and the analysis
    stage's outputs."""
    monkeypatch.setenv("TURING_TPU_FRAME_THREADS", str(frame_threads))
    if capture is not None:
        finalize = Encoder._docket_finalize

        def keep(self, job):
            capture["pre"][job.poc] = [p.copy() for p in job.enc.recon]
            capture["thread"][job.poc] = job.thread
            res = finalize(self, job)
            capture["out"][job.poc] = res[2]
            return res

        encode = Encoder._docket_encode

        def mark(self, job):
            job.thread = threading.get_ident()
            return encode(self, job)

        seeds = device_analysis.install_seed_fields
        subpel = device_analysis.install_subpel_fields

        def keep_seeds(enc, orig):
            res = seeds(enc, orig)
            capture["seeds"].append((np.array(orig[0]), {
                lx: np.array(enc.ref_lists[lx][0].planes[0])
                for lx in res or ()}, res))
            return res

        def keep_subpel(enc):
            res = subpel(enc)
            capture["subpel"].append(({
                lx: np.array(enc.ref_lists[lx][0].planes[0])
                for (lx, _r) in res or ()}, res))
            return res

        monkeypatch.setattr(Encoder, "_docket_finalize", keep)
        monkeypatch.setattr(Encoder, "_docket_encode", mark)
        monkeypatch.setattr(device_analysis, "install_seed_fields",
                            keep_seeds)
        monkeypatch.setattr(device_analysis, "install_subpel_fields",
                            keep_subpel)
    cfg = _load("configs", "ra_fast_1080p_one_idr.json")
    enc = Encoder(EncoderConfig(width=W, height=H, bit_depth=8,
                                device="cpu", **cfg["encoder"]))
    out = []
    for f in frames:
        out += enc.push_frame([p.copy() for p in f])
    out += enc.flush()
    monkeypatch.undo()
    return enc.headers() + b"".join(nal for _i, nal, _r in out), out


@pytest.fixture(scope="module")
def ra():
    """The encode with two pictures in flight, what it captured, and each
    picture's parse (plan, geometry, reference POCs by list) from the
    port's host decoder."""
    frames = _frames()
    cap = {"pre": {}, "out": {}, "thread": {}, "seeds": [], "subpel": []}
    with pytest.MonkeyPatch.context() as mp:
        stream, out = _encode(frames, 2, mp, cap)
    parses = {}
    reconstruct = Decoder._reconstruct

    def keep(self, plan, sh0, poc):
        parses[poc] = (plan, self.geom, [[p.poc for p in lst]
                                         for lst in self._ref_lists_for(plan)])
        return reconstruct(self, plan, sh0, poc)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Decoder, "_reconstruct", keep)
        decoded = {f.poc: f.planes for f in
                   Decoder(device=None).decode_stream(stream)}
    return {"frames": frames, "stream": stream, "out": out, "cap": cap,
            "parses": parses, "decoded": decoded}


def test_the_gop_is_hierarchical_b_with_sao_and_batches(ra):
    cap, parses = ra["cap"], ra["parses"]
    assert [i for i, _nal, _r in ra["out"]] == \
        [0, 8, 4, 2, 1, 3, 6, 5, 7, 16, 12, 10, 9, 11, 14, 13, 15]
    assert sorted(ra["decoded"]) == list(range(N))
    for poc in range(1, N):
        plan, _geom, refs = parses[poc]
        sh = plan.slice_headers[0]
        assert sh.is_b and refs[0] and refs[1], poc
        assert sh.slice_sao_luma_flag and sh.slice_sao_chroma_flag, poc
    # both lists hold distinct pictures wherever the hierarchy gives them
    assert all(parses[p][2][0][0] != parses[p][2][1][0]
               for p in range(1, N) if p % 8)
    # 1 and 3, 5 and 7 (and 9 and 11, 13 and 15) coded at once, each on a
    # worker of its own; the rest on the caller's thread
    main = cap["thread"][8]
    for a, b in ((1, 3), (5, 7), (9, 11), (13, 15)):
        assert main != cap["thread"][a] != cap["thread"][b] != main
    assert all(cap["thread"][p] == main for p in (0, 2, 4, 6, 8, 16))
    # some blocks predict from both lists
    assert any(np.logical_and(parses[p][0].ref_idx[0] >= 0,
                              parses[p][0].ref_idx[1] >= 0).any()
               for p in range(1, N) if p % 8)


@pytest.mark.parametrize("poc", range(1, N))
def test_b_picture_reconstruction_is_the_plain_decode(ra, poc):
    """The encoder's pre-loop-filter planes against MC of both lists and
    the residuals from the picture's parse over the encoder's own
    reference reconstructions, then its returned planes against the plain
    deblocking and SAO of them; and the port's decode of the stream."""
    plan, geom, ref_pocs = ra["parses"][poc]
    cap = ra["cap"]
    refs = [[tuple(cap["out"][r]) for r in lst] for lst in ref_pocs]
    inter, filtered = ref_decode.check_picture(
        plan, geom, refs, cap["pre"][poc], cap["out"][poc])
    assert (inter, filtered) == (0, 0)
    for a, b in zip(ra["decoded"][poc], cap["out"][poc]):
        assert np.array_equal(np.asarray(a), b)


def _diff(got, want) -> int:
    got = np.asarray(got)
    want = want.cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    assert got.shape == want.shape
    return int((got != want).sum())


def test_both_lists_analysis_is_the_plain_reference(ra):
    recons = {k: v[0] for k, v in ra["cap"]["out"].items()}
    seeds, subpel = ra["cap"]["seeds"], ra["cap"]["subpel"]
    assert len(seeds) == len(subpel) == N - 1
    pairs = 0
    for orig, refs, res in seeds:
        assert sorted(res) == [0, 1]
        pairs += not np.array_equal(refs[0], refs[1])
        for lx, ref in refs.items():
            # the stage reads the returned reconstruction of a reference
            assert any(np.array_equal(ref, r) for r in recons.values())
            sm, dm, _wb, _hb, surf = res[lx]
            want = ref_analysis.seed_field(torch.as_tensor(orig),
                                           torch.as_tensor(ref))
            mv, _sad, surface = ref_analysis.dense_field(
                torch.as_tensor(orig), torch.as_tensor(ref), want)
            assert _diff(sm, want) + _diff(dm, mv) == 0
            assert _diff(surf, surface) == 0
    for refs, res in subpel:
        assert sorted(res) == [(0, 0), (1, 0)]
        for (lx, _r), planes in res.items():
            assert _diff(planes, ref_analysis.subpel_planes(
                torch.as_tensor(refs[lx]), 8)) == 0
    # the lists held two different pictures in 14 of the 16
    assert pairs == N - 3


def test_frame_parallel_batches_code_the_same_stream(ra, monkeypatch):
    stream, _out = _encode(ra["frames"], 1, monkeypatch)
    assert stream == ra["stream"]
