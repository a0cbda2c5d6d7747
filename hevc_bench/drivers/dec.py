"""Decode cells: one Decoder fed one stream back to back in a closed loop.

Set-up makes the stream: the pool's first `stream_pictures` frames coded
by the port's Encoder at the configuration's settings (one IDR, then its
GOPs), with the MD5 and SHA-256 of each reconstruction the encoder
returned, in a child process. It keeps them in hevc_bench/cache/, keyed
by the configuration, the traffic and the seed, so only a seed's first
run in a checkout codes them. Set-up then builds the Decoder and decodes the whole stream once.
The window decodes the stream again and again until `seconds` have
passed at a picture's end. Each picture's decode is the decoder's
per-picture call, Decoder._finish_picture, timed from here: its planes
are on the host when it returns. decode_fps is the pictures decoded over
the window's time, decode_p95_ms the 95th percentile of those calls.

Checks, once the window has closed:
- recon_mismatch: for a sample of the window's pictures drawn from the
  seed (an IDR and SAMPLE_OTHERS others, in the first SAMPLE_PASSES
  passes), the samples where the device pipeline's planes differ from
  hevc_bench/reference/decode.py: MC and the inter residuals recomputed
  from the picture's parse and its reference pictures, against the
  pipeline's planes before the loop filters; deblocking and SAO of those
  planes, against its output;
- stream_mismatch: pictures of the stream whose MD5 SEI differs from the
  MD5 of the encoder's reconstruction;
- picture_mismatch: output pictures of the window whose planes differ
  from the reconstruction of their picture order count: a sample drawn
  from the seed, each output with the chance OUTPUT_SAMPLE, held and
  hashed once the window has closed (holding every output would grow the
  process by 6 MB a picture inside the window);
- order_mismatch: per pass through the stream, pictures missing,
  repeated or out of output order.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from hevc_bench.content import make_pool, play_order
from hevc_bench.drivers.enc import encoder_config
from hevc_bench.harness import BENCH, ROOT, patched, percentile
from hevc_bench.reference import decode as ref_decode
from hevc_bench.reference import stream as ref_stream

KERNELS = ("mc_block_grid", "dequant_idct", "deblock", "sao")
# the end-to-end metrics end_to_end() measures, beside setup_s
END_TO_END = ("decode_fps", "decode_p95_ms")
DP = "turingcodec_tpu_torch.decode.device_pipeline"
CACHE = os.path.join(BENCH, "cache")
# the reference check's sample: an IDR and this many other pictures, in
# the window's first passes through the stream
SAMPLE_OTHERS = 5
SAMPLE_PASSES = 3
OUTPUT_SAMPLE = 1 / 8
# code the stream in a child process, so that the measured process never
# runs the Encoder: its loop-filter follower thread wakes every 0.5 ms for
# the rest of the process and slowed the decode by about a tenth (PERF.md)
CODE_IN_CHILD = True


def _annotated(name):
    def factory(orig):
        def f(*a, **k):
            with torch.profiler.record_function(name):
                return orig(*a, **k)
        return f
    return factory


# profiler annotations of the profiled part, naming the host's work in the
# device's idle gaps: the device pipeline, and the host intra inside it
ANNOTATED = [((DP, "decode_picture_device"), _annotated("dec.pipeline")),
             (("turingcodec_tpu_torch.native", "intra_recon"),
              _annotated("dec.intra"))]
# the decoder's kernels and those of the encoder that makes the stream
BUILD = KERNELS + ("seed_field", "dense_me", "subpel_planes", "rank_satd")


def _digest(planes) -> str:
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p, np.int16))
    return h.hexdigest()


def make_stream(config, traffic, seed, device):
    """(stream bytes, {poc: (MD5s, SHA-256)} of the reconstructions) of
    the pool's first stream_pictures frames."""
    from turingcodec_tpu_torch.encode.encoder import Encoder
    c = config
    run = SimpleNamespace(config=c, device=torch.device(device))
    pool = make_pool(traffic, c["width"], c["height"], seed, run.device)
    enc = Encoder(encoder_config(run))
    out = [enc.headers()]
    pics = []
    for f in play_order(len(pool), c["stream_pictures"]):
        pics += enc.push_frame([p.copy() for p in pool[f]])
    pics += enc.flush()
    recon = {}
    for input_index, nal, rec in pics:
        out.append(nal)
        # one IDR: a picture's order count is its input index
        recon[input_index] = (
            [m.hex() for m in ref_stream.planes_md5(rec, c["bit_depth"])],
            _digest(rec))
    return b"".join(out), recon


def _write_stream(name, stream, recon):
    os.makedirs(os.path.dirname(name), exist_ok=True)
    for ext, data, mode in ((".bin", stream, "wb"),
                            (".json", json.dumps(recon), "w")):
        with open(name + ext + ".part", mode) as f:
            f.write(data)
        os.replace(name + ext + ".part", name + ext)


def cached_stream(run):
    """make_stream's result, from hevc_bench/cache/ where an earlier run
    of this checkout made it for the same configuration, traffic and
    seed; else made now, in a child process where CODE_IN_CHILD."""
    key = hashlib.sha256(json.dumps(
        [run.config, run.traffic, run.seed], sort_keys=True).encode())
    name = os.path.join(CACHE, f"{run.cell['config']}.{run.cell['traffic']}"
                               f".{run.seed}.{key.hexdigest()[:16]}")
    try:
        with open(name + ".bin", "rb") as f:
            stream = f.read()
        with open(name + ".json") as f:
            recon = {int(k): v for k, v in json.load(f).items()}
        return stream, recon, True
    except (OSError, ValueError):
        pass
    job = {"config": run.config, "traffic": run.traffic, "seed": run.seed,
           "device": str(run.device), "name": name}
    if not CODE_IN_CHILD:
        _write_stream(name, *make_stream(job["config"], job["traffic"],
                                         job["seed"], job["device"]))
    else:
        p = subprocess.run([sys.executable, "-m", "hevc_bench.drivers.dec"],
                           input=json.dumps(job), capture_output=True,
                           text=True, cwd=ROOT)
        if p.returncode:
            raise RuntimeError("coding the decode stream failed: "
                               + p.stderr[-2000:])
    with open(name + ".bin", "rb") as f:
        stream = f.read()
    with open(name + ".json") as f:
        recon = {int(k): v for k, v in json.load(f).items()}
    return stream, recon, False


def stream_mismatch(stream, recon, n):
    """Pictures whose MD5 SEI, in decode order, is not the MD5 of a
    reconstruction the encoder returned, and pictures missing."""
    want = {tuple(m) for m, _d in recon.values()}
    sei = ref_stream.picture_md5s(stream)
    bad = sum(1 for m in sei if tuple(x.hex() for x in m) not in want)
    return bad + abs(len(sei) - n) + abs(len(recon) - n)


def setup(run):
    from turingcodec_tpu_torch.decode.decoder import Decoder
    n = run.config["stream_pictures"]
    st = SimpleNamespace(times=[], passes=[], n=0, elapsed=0.0, t_end=0.0,
                         cap=[], k=0, capturing=None)
    st.stream, recon, cached = cached_stream(run)
    st.stream_bad = stream_mismatch(st.stream, recon, n)
    st.expect = {poc: d for poc, (_m, d) in recon.items()}
    run.info.append(f"decode stream: {len(st.stream)} bytes, {n} pictures, "
                    f"{'from the cache' if cached else 'coded in set-up'}")
    rng = random.Random(run.seed)
    others = rng.sample(range(SAMPLE_PASSES * (n - 1)), SAMPLE_OTHERS)
    st.sample = {rng.randrange(SAMPLE_PASSES) * n} | {
        (o // (n - 1)) * n + 1 + o % (n - 1) for o in others}
    st.rng = rng
    st.dec = Decoder(device=str(run.device))
    inner = st.dec._finish_picture

    def finish(slices):
        t0 = time.perf_counter()
        if st.stage_trace:
            with run.span("dec.picture"):
                out = inner(slices)
        else:
            with torch.profiler.record_function("dec.picture"):
                out = inner(slices)
        t1 = time.perf_counter()
        if st.timing:
            st.times.append(t1 - t0)
            st.t_end = t1
        return out

    st.dec._finish_picture = finish
    st.stage_trace = st.timing = False
    for _ in st.dec.decode_stream(st.stream):
        pass
    return st


def _capturing(st):
    """patched() pairs that keep, for the sampled pictures of the window,
    what the reference check reads: the picture's parse, its reference
    pictures' planes, the planes that enter the deblocking filter (a copy
    on the device) and the pipeline's output."""
    def pipeline(orig):
        def f(pr, device):
            k = st.k
            st.k += 1
            if k not in st.sample:
                return orig(pr, device)
            st.capturing = {"plan": pr.plan, "geom": pr.geom, "refs": [
                [tuple(p.planes[:3]) for p in lst] for lst in pr.ref_lists]}
            try:
                out = orig(pr, device)
            finally:
                cap, st.capturing = st.capturing, None
            if out is not None and "pre" in cap:
                cap["out"] = out
                st.cap.append(cap)
            return out
        return f

    def deblock(orig):
        def f(plan, geom, planes, *a, **k):
            if st.capturing is not None:
                st.capturing["pre"] = [p.clone() for p in planes]
            return orig(plan, geom, planes, *a, **k)
        return f

    return [((DP, "decode_picture_device"), pipeline),
            ((DP, "deblock_planes_device"), deblock)]


def window(run, st, seconds, stage_trace=False, part="window"):
    """Decode the stream back to back until `seconds` have passed at a
    picture's end."""
    from turingcodec_tpu_torch.decode import device_pipeline as dp
    timed = part == "window"
    st.stage_trace = timed and stage_trace
    if st.stage_trace:
        os.environ["TURING_TPU_PIPELINE_TRACE"] = "1"
        dp.stage_seconds.clear()
        st.pipeline_pictures = dp.pictures
    st.timing = timed
    t0 = time.perf_counter()
    done = False
    try:
        with contextlib.ExitStack() as stack:
            if st.stage_trace:
                # the stage trace prints a line per stage to stderr
                stack.enter_context(contextlib.redirect_stderr(
                    stack.enter_context(open(os.devnull, "w"))))
            stack.enter_context(patched(_capturing(st) if timed
                                        else ANNOTATED))
            while not done:
                if timed:
                    st.passes.append([])
                for fr in st.dec.decode_stream(st.stream):
                    if timed:
                        st.passes[-1].append(
                            (fr.poc, fr.planes
                             if st.rng.random() < OUTPUT_SAMPLE else None))
                    if time.perf_counter() - t0 >= seconds:
                        done = True
                        break
    finally:
        st.timing = False
        if st.stage_trace:
            os.environ.pop("TURING_TPU_PIPELINE_TRACE", None)
            st.stages = dict(dp.stage_seconds)
            st.pipeline_pictures = dp.pictures - st.pipeline_pictures
            run.info.append("pipeline stages, ms a picture: " + json.dumps(
                {k: 1e3 * v / max(1, st.pipeline_pictures)
                 for k, v in st.stages.items()}))
        st.stage_trace = False
    if timed:
        st.n = len(st.times)
        st.elapsed = st.t_end - t0
        n = len(st.expect)
        per = [round(1e3 * sum(st.times[i:i + n]), 1)
               for i in range(0, st.n, n)]
        run.info.append(f"decode ms per {n} pictures: {per}")


def release(run, st):
    st.dec = None


def end_to_end(run, st, name):
    if name == "decode_fps":
        return st.n / st.elapsed
    if name == "decode_p95_ms":
        return 1e3 * percentile(st.times, 95)
    return None


def recon_mismatch(run, st):
    """Samples of the sampled pictures where the pipeline differs from
    the plain reference, and one for each sampled picture the window did
    not reach."""
    inter = filtered = 0
    for cap in st.cap:
        pre = [p.cpu().numpy() for p in cap["pre"]]
        i, f = ref_decode.check_picture(cap["plan"], cap["geom"],
                                        cap["refs"], pre, cap["out"])
        inter += i
        filtered += f
    missing = len(st.sample) - len(st.cap)
    run.info.append(f"reference check: {len(st.cap)} pictures, {inter} "
                    f"inter samples and {filtered} loop-filtered samples "
                    f"differ, {missing} sampled pictures not reached")
    return inter + filtered + missing


def check(run, st):
    n = len(st.expect)
    wrong = order = checked = 0
    passes = len(st.passes)
    for k, outs in enumerate(st.passes):
        pocs = [p for p, _planes in outs]
        held = [(p, planes) for p, planes in outs if planes is not None]
        checked += len(held)
        wrong += sum(1 for p, planes in held
                     if st.expect.get(p) != _digest(planes))
        order += sum(1 for a, b in zip(pocs, pocs[1:]) if b <= a)
        if k < len(st.passes) - 1:
            order += n - len(set(pocs) & set(st.expect))
    st.wrong, st.order = wrong, order
    outputs = sum(len(o) for o in st.passes)
    st.passes = []
    run.checks += [("recon_mismatch", recon_mismatch(run, st), 0),
                   ("stream_mismatch", st.stream_bad, 0),
                   ("picture_mismatch", wrong, 0),
                   ("order_mismatch", order, 0)]
    run.info.append(f"decode: {st.n} pictures in {st.elapsed:.6f} s, "
                    f"{outputs} output, {checked} of them checked, "
                    f"{passes} passes of {n}; p95 over {st.n} samples")


def counts(run, st):
    return st.n, min(st.n, st.wrong + st.order)


if __name__ == "__main__":
    # the child that codes a stream: its job as JSON on standard input
    _job = json.loads(sys.stdin.read())
    _write_stream(_job["name"], *make_stream(
        _job["config"], _job["traffic"], _job["seed"], _job["device"]))
