"""Encode cells: one Encoder fed the traffic's pool in a closed loop.

Set-up makes the pool, builds the Encoder of the configuration and codes
the IDR and the first inter picture. The window then pushes the pool's
next frame as soon as the last push returns, until `seconds` have passed
at a picture's end; encode_fps is the pictures coded over that time.

Checks, once the window has closed and the encoder is gone:
- analysis_mismatch: the analysis stage's device outputs (seed and dense
  fields, SAD surface, subpel planes, rank-SATD tables) of a sample of
  the window's pictures drawn from the seed, element by element against
  hevc_bench/reference/analysis.py computed from the planes the stage was
  given; and one for each such plane that is neither a pool frame (a
  source) nor a reconstruction the encoder returned (a reference);
- hash_mismatch: pictures whose MD5 picture-hash SEI (read by
  hevc_bench/reference/stream.py) differs from the MD5 of the
  reconstruction the encoder returned with it;
- decode_mismatch: pictures whose decode by the port's card decoder (a
  witness beside the reference) differs from that reconstruction, or is
  missing;
- distortion_db: the luma squared error of the window's reconstructions
  against the pool frames they were coded from, over that of
  hevc_bench/reference/distortion.py's plain transform coder at the
  configuration's QP on the same frames, in dB; held to
  DISTORTION_LIMIT_DB. The window's PSNR and coded bits a picture are
  printed beside it.
"""
from __future__ import annotations

import hashlib
import random
import time
from types import SimpleNamespace

import numpy as np
import torch

from hevc_bench.content import make_pool, play_order
from hevc_bench.reference import analysis as ref_analysis
from hevc_bench.reference import distortion as ref_distortion
from hevc_bench.reference import stream as ref_stream

KERNELS = ("seed_field", "dense_me", "subpel_planes", "rank_satd")
# the end-to-end metrics end_to_end() measures, beside setup_s
END_TO_END = ("encode_fps",)
# the kernels a run launches: the analysis stage's and the witness decode's
BUILD = KERNELS + ("mc_block_grid", "dequant_idct", "deblock", "sao")
DA = "turingcodec_tpu_torch.encode.device_analysis"
# the analysis check's sample: the window's first picture, then each with
# this chance, at most SAMPLE_MAX in all (keeps the check under the window)
SAMPLE_RATE = 1 / 8
SAMPLE_MAX = 8
# distortion_db's limit, set from the sound runs and the coarser-QP
# control's readings (PERF.md section 2)
DISTORTION_LIMIT_DB = 3.5


def encoder_config(run):
    from turingcodec_tpu_torch.encode.encoder import EncoderConfig
    c = run.config
    return EncoderConfig(width=c["width"], height=c["height"],
                         bit_depth=c["bit_depth"], device=str(run.device),
                         **c["encoder"])


def _wrappers(run, st):
    """The analysis stage's three entry points, timed as spans in a traced
    window and captured for the checks on the sampled pictures."""
    def span(name):
        if st.mode == "window" and st.stage_trace:
            return run.span(name, sync=True)
        return torch.profiler.record_function(name)

    def seeds(orig_fn):
        def wrapped(enc, orig):
            with span("enc.analysis"):
                res = orig_fn(enc, orig)
            if st.sampled and res:
                refs = {lx: np.array(enc.ref_lists[lx][0].planes[0])
                        for lx in res}
                st.cap.append(("seeds", orig[0], refs, res))
            return res
        return wrapped

    def subpel(orig_fn):
        def wrapped(enc):
            with span("enc.analysis"):
                res = orig_fn(enc)
            if st.sampled and res:
                refs = {lx: np.array(enc.ref_lists[lx][0].planes[0])
                        for (lx, _i) in res}
                st.cap.append(("subpel", enc.sps.bit_depth_y, refs, res))
            return res
        return wrapped

    def rank(orig_fn):
        def wrapped(plane, zscan, bd, strong, device, *a, **k):
            with span("enc.analysis"):
                res = orig_fn(plane, zscan, bd, strong, device, *a, **k)
            if st.sampled:
                st.cap.append(("rank", plane, (bd, bool(strong)), res))
            return res
        return wrapped

    return [((DA, "install_seed_fields"), seeds),
            ((DA, "install_subpel_fields"), subpel),
            ((DA, "rank_satd_tables_device"), rank)]


def setup(run):
    from hevc_bench.harness import patched
    from turingcodec_tpu_torch.encode.encoder import Encoder
    c = run.config
    st = SimpleNamespace(mode="setup", stage_trace=False, sampled=False,
                         cap=[], out=[], pos=0, n=0,
                         elapsed=0.0, k=0, n_sampled=0,
                         rng=random.Random(run.seed))
    st.pool = make_pool(run.traffic, c["width"], c["height"], run.seed,
                        run.device)
    st.order = play_order(len(st.pool), 2 * len(st.pool) - 2)
    st.enc = Encoder(encoder_config(run))
    st.header = st.enc.headers()
    st.patch = patched(_wrappers(run, st))
    st.patch.__enter__()
    # the IDR and the first inter picture: every shape the window uses
    for _ in range(2):
        _push(st)
    return st


def _push(st):
    f = st.order[st.pos % len(st.order)]
    st.pos += 1
    res = st.enc.push_frame([p.copy() for p in st.pool[f]])
    st.out += res
    return len(res)


def window(run, st, seconds, stage_trace=False, part="window"):
    """Push frames until `seconds` have passed at a picture's end."""
    st.mode, st.stage_trace = part, stage_trace
    st.pic_ms = []
    n = 0
    first = len(st.out)
    t0 = time.perf_counter()
    while True:
        if part == "window":
            st.sampled = st.k == 0 or (st.rng.random() < SAMPLE_RATE
                                       and st.n_sampled < SAMPLE_MAX)
            st.n_sampled += st.sampled
            st.k += 1
        t1 = time.perf_counter()
        if part == "window" and stage_trace:
            with run.span("enc.picture", sync=True):
                n += _push(st)
        else:
            with torch.profiler.record_function("enc.picture"):
                n += _push(st)
        st.sampled = False
        t = time.perf_counter() - t0
        st.pic_ms.append(round(1e3 * (time.perf_counter() - t1), 1))
        if t >= seconds:
            break
    if part == "window":
        st.n, st.elapsed = n, t
        st.window_out = (first, len(st.out))
        run.info.append(f"encode ms per picture: {st.pic_ms}")
    st.mode = "done"


def release(run, st):
    st.patch.__exit__(None, None, None)
    st.enc = None


def end_to_end(run, st, name):
    if name == "encode_fps":
        return st.n / st.elapsed
    return None


def _key(plane) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(plane, np.int16)).digest()


def _analysis_mismatch(run, st):
    """Differing elements of the sampled pictures' analysis outputs, and
    one for each input plane that is neither a pool frame (sources) nor a
    returned reconstruction (references)."""
    dev = run.device
    sources = {_key(f[0]) for f in st.pool}
    recons = {_key(o[2][0]) for o in st.out}
    bad = 0
    ctb_log2 = run.config["encoder"].get("ctb_log2", 6)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def diff(got, want):
        got = np.asarray(got)
        want = want.cpu().numpy() if torch.is_tensor(want) else want
        if got.shape != want.shape:
            return int(want.size) or 1
        return int((got != want).sum())

    for kind, a, refs, res in st.cap:
        if kind == "seeds":
            orig = t(a)
            bad += _key(a) not in sources
            for lx, plane in refs.items():
                bad += _key(plane) not in recons
                sm, dm, wb, hb, surf = res[lx]
                seeds = ref_analysis.seed_field(orig, t(plane))
                mv, sad, surface = ref_analysis.dense_field(orig, t(plane),
                                                            seeds)
                bad += diff(sm, seeds) + diff(dm, mv)
                if surf is not None:
                    bad += diff(surf, surface)
        elif kind == "subpel":
            for (lx, _i), planes in res.items():
                bad += _key(refs[lx]) not in recons
                bad += diff(planes, ref_analysis.subpel_planes(
                    t(refs[lx]), a))
        else:
            bd, strong = refs
            bad += _key(a) not in sources
            want = ref_analysis.rank_tables(t(a), ctb_log2,
                                            run.config["bit_depth"], True)
            bad += int(bd != run.config["bit_depth"]) + int(not strong)
            if sorted(res) != sorted(want):
                bad += 1
            for n in want:
                if n in res:
                    bad += diff(res[n], want[n])
    return bad


def distortion_db(run, st):
    """The window's luma squared error against its sources over the plain
    anchor's at the configuration's QP, in dB."""
    c = run.config
    sse = anchor = bits = 0.0
    anchors = {}
    first, last = st.window_out
    for i, nal, recon in st.out[first:last]:
        f = st.order[i % len(st.order)]
        src = st.pool[f][0]
        if f not in anchors:
            anchors[f] = ref_distortion.anchor_sse(
                src, c["encoder"]["qp"], c["bit_depth"])
        sse += ref_distortion.luma_sse(recon[0], src)
        anchor += anchors[f]
        bits += 8 * len(nal)
    n = max(1, last - first)
    peak = ((1 << c["bit_depth"]) - 1) ** 2
    size = c["width"] * c["height"] * n
    run.info.append(
        f"distortion: {n} pictures, luma PSNR "
        f"{10 * np.log10(peak * size / max(sse, 1e-9)):.4f} dB, the "
        f"anchor's {10 * np.log10(peak * size / max(anchor, 1e-9)):.4f} dB,"
        f" {bits / n:.1f} coded bits a picture")
    return 10 * float(np.log10(max(sse, 1e-9) / max(anchor, 1e-9)))


def check(run, st):
    from turingcodec_tpu_torch.decode.decoder import Decoder
    pictures = {o[0]: o for o in st.out}
    hash_bad = 0
    for _i, nal, recon in st.out:
        sei = ref_stream.picture_md5s(nal)
        if len(sei) != 1 or sei[0] != ref_stream.planes_md5(
                recon, run.config["bit_depth"]):
            hash_bad += 1
    seen = set()
    dec_bad = 0
    data = st.header + b"".join(o[1] for o in st.out)
    try:
        for fr in Decoder(device=str(run.device)).decode_stream(data):
            seen.add(fr.poc)
            o = pictures.get(fr.poc)
            if o is None or not all(np.array_equal(np.asarray(a), b)
                                    for a, b in zip(fr.planes, o[2])):
                dec_bad += 1
    except Exception as e:  # a stream the decoder refuses: the rest missing
        run.info.append(f"witness decode stopped: {type(e).__name__}: {e}")
    dec_bad += len(set(pictures) - seen)
    run.checks += [("analysis_mismatch", _analysis_mismatch(run, st), 0),
                   ("hash_mismatch", hash_bad, 0),
                   ("decode_mismatch", dec_bad, 0),
                   ("distortion_db", distortion_db(run, st),
                    DISTORTION_LIMIT_DB)]
    run.info.append(f"encode: {st.n} pictures in the window, "
                    f"{len(st.out)} coded, "
                    f"{sum(1 for c in st.cap if c[0] == 'seeds')} sampled "
                    f"for the analysis check")
    st.hash_bad, st.dec_bad = hash_bad, dec_bad


def counts(run, st):
    return st.n, min(st.n, st.hash_bad + st.dec_bad)
