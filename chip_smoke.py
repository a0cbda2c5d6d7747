"""Smoke run of the PyTorch / H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain torch version on the card, holds every
encoder analysis stage on the card against its host twin at 1080p, then
drives the main path: decode tests/streams/vfy_sweep.hevc (md5 against
tests/streams/GOLDEN.json), upscale it 3x to 1920x1080, encode 8 frames at
the fast low-delay-P operating point with the analysis stage on the card
and on the host, check byte-identical bitstreams, and decode the result
hash-clean. Any failed check raises and the exit code is non-zero.

The last three lines of standard output are the card's name and power
limit as nvidia-smi reports them, the kernels' JSON record, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM = os.path.join(ROOT, "tests", "streams", "vfy_sweep.hevc")
GOLDEN = os.path.join(ROOT, "tests", "streams", "GOLDEN.json")
N_FRAMES = 8
QP = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what) -> None:
    """Raise when a check fails (kept under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_ms(fn, device, reps: int) -> float:
    """Median time of fn() in ms: CUDA events around each call on a card,
    the host clock elsewhere. One warm-up call first."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wall_ms(fn, device, reps: int) -> float:
    """Median host-clock time of fn() in ms, synchronised (host to host:
    upload, compute and download as the encoder pays them)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def decode_inputs(n_frames: int, upscale: int):
    """Decode vfy_sweep with the port (md5 against the golden), and return
    the first n_frames upscaled by nearest neighbour, as bench.py does."""
    import numpy as np

    from turingcodec_tpu_torch.decode.decoder import Decoder
    dec = Decoder()
    md5 = hashlib.md5()
    frames = []
    for f in dec.decode_stream(open(STREAM, "rb").read()):
        check(f.hash_ok is not False, "vfy_sweep: hash SEI mismatch")
        planes = [np.asarray(p) for p in f.planes]
        for p in planes:
            md5.update(p.astype(np.uint8).tobytes())
        frames.append(planes)
    want = json.load(open(GOLDEN))["vfy_sweep.hevc"]
    check(md5.hexdigest() == want,
          f"vfy_sweep md5 {md5.hexdigest()} != golden {want}")
    log(f"decode vfy_sweep: {len(frames)} frames "
        f"{frames[0][0].shape[1]}x{frames[0][0].shape[0]}, md5 {want} OK")
    ones = np.ones((upscale, upscale), np.uint8)
    ups = [[np.kron(p.astype(np.uint8), ones).astype(np.int16)
            for p in planes] for planes in frames[:n_frames]]
    return ups


def check_kernel(device, orig, ref, reps):
    """dense_me_argmin against dense_me_argmin_ref on the device."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.ops.dense_me import (dense_me_argmin,
                                                    dense_me_argmin_ref)

    def compare(name, cur, pat):
        got = dense_me_argmin(cur, pat)
        if device.type == "cuda":
            torch.cuda.synchronize()
        want = dense_me_argmin_ref(cur, pat)
        err = int((got.to(torch.int64) - want).abs().max()) \
            if got.numel() else 0
        check(torch.equal(got.cpu(), want.cpu()),
              f"kernel differs from its plain version: {name}")
        log(f"kernel vs plain, {name}: B={cur.shape[0]} equal")
        return err

    rng = np.random.default_rng(7)
    b = 7
    cur = rng.integers(0, 256, (b, 16, 16)).astype(np.int32)
    pat = rng.integers(0, 256, (b, 32, 32)).astype(np.int32)
    pat[0, 8:24, 8:24] = cur[0]          # offset (0, 0)
    pat[1, 0:16, 0:16] = cur[1]          # offset (-8, -8)
    pat[2, 16:32, 13:29] = cur[2]        # offset (+5, +8)
    errs = [compare("planted matches",
                    torch.from_numpy(cur).to(device),
                    torch.from_numpy(pat).to(device))]
    cur = rng.integers(0, 1024, (4096, 16, 16)).astype(np.int32)
    pat = rng.integers(0, 1024, (4096, 32, 32)).astype(np.int32)
    errs.append(compare("random 10-bit", torch.from_numpy(cur).to(device),
                        torch.from_numpy(pat).to(device)))
    errs.append(compare(
        "all equal (every SAD ties)",
        torch.full((64, 16, 16), 77, dtype=torch.int32, device=device),
        torch.full((64, 32, 32), 77, dtype=torch.int32, device=device)))

    h, w = orig.shape
    wb, hb = da.block_dims(w, h)
    o, r = da.upload(orig, device), da.upload(ref, device)
    cb, patch = da.dense_inputs(o, r, da.seed_field(o, r, wb, hb),
                                w, h, wb, hb)
    errs.append(compare(f"{w}x{h} frame pair", cb, patch))
    ms = timed_ms(lambda: dense_me_argmin(cb, patch), device, reps)
    plain_ms = timed_ms(lambda: dense_me_argmin_ref(cb, patch), device,
                        max(1, reps // 4))
    log(f"dense_me_argmin at B={cb.shape[0]}: kernel {ms:.4f} ms, "
        f"plain torch {plain_ms:.4f} ms (median, CUDA events)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "B": int(cb.shape[0])}


def check_stages(device, orig, ref, zscan, reps):
    """Every analysis stage on the device against its host twin."""
    import numpy as np

    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.encode import device_analysis as da
    h, w = orig.shape
    times = {}

    nat = native.dense_analysis(orig, ref, 8)
    check(nat is not None, "native dense_analysis unavailable")
    sm_n, dm_n, ds_n, wb_n, hb_n = nat[:5]
    sm, wb, hb = da.seed_field_device(orig, ref, device)
    check((wb, hb) == (wb_n, hb_n) and np.array_equal(sm, sm_n),
          "seed field differs from the native host twin")
    times["seed_field_device"] = wall_ms(
        lambda: da.seed_field_device(orig, ref, device), device, reps)
    sm, dm, ds, wb, hb = da.analysis_device(orig, ref, device)
    check(np.array_equal(sm, sm_n) and np.array_equal(dm, dm_n)
          and np.array_equal(ds, ds_n),
          "seed/dense/SAD fields differ from the native host twin")
    times["analysis_device"] = wall_ms(
        lambda: da.analysis_device(orig, ref, device), device, reps)
    log(f"seed + dense fields {w}x{h}: equal to the native host twin")

    for bd in (8, 10):
        plane = ((ref << (bd - 8)) + (orig & ((1 << (bd - 8)) - 1))
                 ).astype(np.int16)
        got = da.subpel_planes_device(plane, bd, device)
        check(np.array_equal(got, da.subpel_planes_host(plane, bd)),
              f"{bd}-bit subpel planes differ from the numpy twin")
        log(f"subpel planes {bd}-bit: equal to the numpy twin")
        times[f"subpel_planes_device_{bd}bit"] = wall_ms(
            lambda: da.subpel_planes_device(plane, bd, device), device, reps)

    got = da.rank_satd_tables_device(orig, zscan, 8, True, device)
    want = da.rank_satd_tables_host(orig, zscan, 8, True)
    check(sorted(got) == sorted(want), "rank-SATD table sizes differ")
    for n in want:
        check(np.array_equal(got[n], want[n]),
              f"rank-SATD table n={n} differs from the numpy twin")
    log("rank-SATD tables n=4..32: equal to the numpy twin")
    times["rank_satd_tables_device"] = wall_ms(
        lambda: da.rank_satd_tables_device(orig, zscan, 8, True, device),
        device, reps)
    for k, v in times.items():
        log(f"stage {k} per {w}x{h} picture: {v:.3f} ms "
            f"(median, host clock incl. transfers)")
    return times


def encode(frames, device):
    """Encode at bench.py's operating point; returns (bitstream, fps)."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    h, w = frames[0][0].shape
    cfg = EncoderConfig(width=w, height=h, qp=QP, rd_candidates=1,
                        search_range=32, gop_m=1, sao=False, rdoq=True,
                        sdh=True, device=device)
    enc = Encoder(cfg)
    out = [enc.headers()]
    t0 = time.perf_counter()
    for fr in frames:
        for (_i, nal, _r) in enc.push_frame([p.copy() for p in fr]):
            out.append(nal)
    for (_i, nal, _r) in enc.flush():
        out.append(nal)
    return b"".join(out), len(frames) / (time.perf_counter() - t0)


def main_path(frames, device):
    """The encode with the stage on the device and on the host; returns
    (kernel launches in the device run, fps device, fps host)."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.ops import dense_me
    dense_me.launches = 0
    bs_dev, fps_dev = encode(frames, str(device))
    launches = dense_me.launches
    bs_host, fps_host = encode(frames, None)
    check(bs_dev == bs_host, "device and host bitstreams differ")
    n_p = len(frames) - 1   # low-delay P: one IDR, then P pictures
    check(launches >= n_p,
          f"{launches} dense_me_argmin launches for {n_p} P pictures")
    dec = Decoder()
    n = sum(1 for _ in dec.decode_stream(bs_dev))
    check(n == len(frames) and dec.hash_failures == 0,
          f"decoded {n} frames, {dec.hash_failures} hash failures")
    h, w = frames[0][0].shape
    log(f"encode {len(frames)} frames {w}x{h}: device={device} "
        f"{fps_dev:.4f} fps, host {fps_host:.4f} fps, {len(bs_dev)} bytes "
        f"identical; dense_me_argmin launches {launches} (>= {n_p} P "
        f"pictures); decoded {n} frames, 0 hash failures")
    return launches, fps_dev, fps_host


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    # run the checkout this script sits in, never a copy found elsewhere
    pkg = os.path.join(ROOT, "turingcodec_tpu_torch")
    if not os.path.isdir(pkg):
        print(f"chip_smoke: {pkg} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.ops import kernel_build

    # 1. environment
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    log("nvcc: " + subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout
        .strip().splitlines()[-1])
    device = torch.device("cuda", 0)

    # 2. build: the CUDA kernels from source, and the native host core
    t0 = time.perf_counter()
    kernel_build.build("dense_me", force=True)
    log(f"built csrc/dense_me.cu for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "native host core did not build")
    log(f"native host core ready in {time.perf_counter() - t0:.1f} s")

    frames = decode_inputs(N_FRAMES, 3)
    orig, ref = frames[1][0], frames[0][0]
    h, w = orig.shape
    check((w, h) == (1920, 1080), f"upscaled input is {w}x{h}")

    # 3. kernel against its plain version on the card
    kern = check_kernel(device, orig, ref, reps=20)

    # 4. stages against their host twins
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    geom = Encoder(EncoderConfig(width=w, height=h, qp=QP,
                                 rd_candidates=1)).geom
    check_stages(device, orig, ref, geom.zscan, reps=5)

    # 5. main path
    launches, fps_dev, fps_host = main_path(frames, device)

    log(card)
    log(json.dumps({"kernels": [{
        "name": "dense_me_argmin", "route": "cuda",
        "source": "turingcodec_tpu_torch/csrc/dense_me.cu",
        "replaces": "turingcodec_tpu/ops/pallas_kernels.py:71",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
