"""BD-rate harness: our encoder's rate-distortion points, and its
Bjontegaard delta-rate against the reference `turing` encoder where that
binary exists (port of `turingcodec_tpu/tools/bdrate.py`).

Encodes 4 QP points (26/30/34/38) of each sequence at three operating
points (fast low delay, fast and slow random access GOP8) and computes the
piecewise-linear BD-rate from luma PSNR. The sequences are in-repo:
tests/streams/vfy_sweep.hevc (640x360, 9 frames), its deterministic 3x
nearest-neighbour upscale to 1920x1080, and a synthetic 320x192 moving
gradient with noise.

Usage:
    python -m turingcodec_tpu_torch.tools.bdrate [--quick] [--only NAME]
        [--device {cuda,none,cpu}] [--out FILE.md] [--json FILE]

The reference binary (REF_BIN, build recipe in .claude/skills/verify/
SKILL.md) runs only where it exists; without it the tool prints our points
alone and says so. Nothing is written unless --out or --json names a file
(the reference's inputs and outputs go under build/bdrate/, gitignored).
--device cuda (the default) runs the encoder's analysis stage on the GPU
and raises without one; none is the host path; cpu runs the device code
through the kernels' plain versions. Every device gives the same bytes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REF_BIN = "/tmp/turing-dbg/turing/turing"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STREAM = os.path.join(ROOT, "tests", "streams", "vfy_sweep.hevc")
WORK_DIR = os.path.join(ROOT, "build", "bdrate")
QPS = (26, 30, 34, 38)
POINTS = (("fast", 1, "fast-LDP (max-gop-m 1)"),
          ("fast", 8, "fast-RA (max-gop-m 8)"),
          ("slow", 8, "slow-RA (max-gop-m 8)"))


def psnr_y(a, b):
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 * 255.0 / mse)


def bd_rate(r_ref, p_ref, r_test, p_test):
    """Piecewise-linear Bjontegaard delta-rate (%) of test vs ref."""
    lo = max(min(p_ref), min(p_test))
    hi = min(max(p_ref), max(p_test))
    xs = np.linspace(lo, hi, 256)
    lr = np.interp(xs, p_ref, np.log(np.asarray(r_ref, np.float64)))
    lt = np.interp(xs, p_test, np.log(np.asarray(r_test, np.float64)))
    return float((np.exp(np.mean(lt - lr)) - 1.0) * 100.0)


def decode_clip(n_frames=None):
    """vfy_sweep's first frames as lists of int16 planes (host decode)."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    with open(STREAM, "rb") as f:
        data = f.read()
    return [[np.asarray(p).astype(np.int16) for p in fr.planes]
            for fr in Decoder(device=None).decode_stream(
                data, max_frames=n_frames)]


def upscale3(frames):
    """The deterministic 3x nearest-neighbour upscale of 640x360 frames to
    1920x1080 (chroma 960x540)."""
    return [[np.kron(p.astype(np.uint8), np.ones((3, 3), np.uint8))
             .astype(np.int16) for p in planes] for planes in frames]


def synthetic(n_frames, w=320, h=192):
    """A moving gradient with a static texture layer and per-frame noise
    (no natural-content bias); the texture keeps the motion-compensated
    residual nonzero at every QP."""
    rng = np.random.RandomState(42)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.int16)
    tex = rng.randint(-24, 25, (h, w)).astype(np.int16)
    noise = rng.randint(-8, 9, (h + 16, w + 16)).astype(np.int16)
    out = []
    for i in range(n_frames):
        y = np.clip(np.roll(base + tex, i * 2, 1)
                    + noise[i:i + h, i:i + w], 0, 255).astype(np.int16)
        out.append([y, np.full((h // 2, w // 2), 128, np.int16),
                    np.full((h // 2, w // 2), 128, np.int16)])
    return out


def load_sequences(quick: bool):
    clip = decode_clip()
    return {"vfy_sweep-640x360": clip,
            "vfy_sweep-1080p-3x": upscale3(clip[:4 if quick else 8]),
            "synthetic-320x192": synthetic(8 if quick else 16)}


def write_yuv(frames, path):
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                f.write(np.asarray(p).astype(np.uint8).tobytes())


def encoder_config(w, h, qp, preset, gop_m, device):
    from turingcodec_tpu_torch.encode.encoder import EncoderConfig
    # hash_type=None: the reference emits no decoded-picture-hash SEI, so
    # ours must not either (its ~54 B/frame would skew low-rate points)
    if preset == "fast":
        return EncoderConfig(width=w, height=h, qp=qp, rd_candidates=1,
                             search_range=32, gop_m=gop_m, sao=False,
                             rdoq=True, sdh=True, hash_type=None,
                             device=device)
    return EncoderConfig(width=w, height=h, qp=qp, rd_candidates=3,
                         search_range=64, gop_m=gop_m, sao=True, rdoq=True,
                         sdh=True, hash_type=None, device=device)


def encode_ours(frames, qp, preset, gop_m, device="cuda"):
    """(bitstream, {display index: recon planes}, seconds) of our encode."""
    from turingcodec_tpu_torch.encode.encoder import Encoder
    h, w = frames[0][0].shape
    enc = Encoder(encoder_config(w, h, qp, preset, gop_m, device))
    nals = [enc.headers()]
    recs = {}
    t0 = time.perf_counter()
    for fr in frames:
        for (i, nal, rec) in enc.push_frame([p.copy() for p in fr]):
            nals.append(nal)
            recs[i] = rec
    for (i, nal, rec) in enc.flush():
        nals.append(nal)
        recs[i] = rec
    return b"".join(nals), recs, time.perf_counter() - t0


def run_ours(frames, qp, preset, gop_m, device="cuda"):
    """(bytes, mean luma PSNR, frames/s) of our encode."""
    bs, recs, dt = encode_ours(frames, qp, preset, gop_m, device)
    ps = float(np.mean([psnr_y(np.asarray(recs[i][0]), frames[i][0])
                        for i in range(len(frames))]))
    return len(bs), ps, len(frames) / dt


def run_reference(yuv_path, w, h, n, qp, preset, gop_m, tag):
    out = os.path.join(WORK_DIR, f"ref_{tag}.hevc")
    rec = os.path.join(WORK_DIR, f"ref_{tag}.yuv")
    cmd = [REF_BIN, "encode", "--input-res", f"{w}x{h}",
           "--frames", str(n), "--frame-rate", "24", "--qp", str(qp),
           "--speed", preset, "--max-gop-m", str(gop_m),
           "--threads", "2", "--dump-frames", rec, "-o", out, yuv_path]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True)
    dt = time.perf_counter() - t0
    fsz = w * h * 3 // 2
    src = np.fromfile(yuv_path, np.uint8)[:n * fsz]
    dec = np.fromfile(rec, np.uint8)[:n * fsz]
    ps = float(np.mean([
        psnr_y(src[i * fsz:i * fsz + w * h], dec[i * fsz:i * fsz + w * h])
        for i in range(n)]))
    return os.path.getsize(out), ps, n / dt


def report(results, quick, have_ref):
    lines = ["# BD-rate vs the reference encoder", "",
             "Reproduce: `python -m turingcodec_tpu_torch.tools.bdrate"
             + (" --quick" if quick else "") + "`",
             "(4 QP points 26/30/34/38, piecewise-linear BD on luma PSNR; "
             "negative BD-rate = we need fewer bits at equal PSNR).", ""]
    if not have_ref:
        lines += [f"The reference binary ({REF_BIN}) is absent: our points "
                  "alone, no BD-rate.", ""]
    lines += ["| sequence / operating point | BD-rate | our fps | ref fps |",
              "|---|---|---|---|"]
    for key, r in results.items():
        bd = (f"{r['bd_rate_pct']:+.2f}%" if r["bd_rate_pct"] is not None
              else "-")
        ref_fps = r["reference"]["fps"] if r["reference"] else "-"
        lines.append(f"| {key} | {bd} | {r['ours']['fps']} | {ref_fps} |")
    lines += ["", "Raw points (bytes @ PSNR-Y per QP 26/30/34/38):",
              "```json", json.dumps(results, indent=1), "```"]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch bdrate")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write the markdown report here (default: none)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", default=None,
                    help="substring filter on sequence names")
    ap.add_argument("--device", choices=["cuda", "none", "cpu"],
                    default="cuda")
    args = ap.parse_args(argv)
    device = None if args.device == "none" else args.device
    if device is not None:
        from turingcodec_tpu_torch.encode.device_analysis import (
            resolve_device)
        resolve_device(device)   # raises without a usable card

    have_ref = os.path.exists(REF_BIN)
    if not have_ref:
        print(f"reference binary {REF_BIN} absent: our points only, no "
              f"BD-rate", flush=True)
    seqs = load_sequences(args.quick)
    if args.only:
        seqs = {k: v for k, v in seqs.items() if args.only in k}
    results = {}
    for sname, frames in seqs.items():
        h, w = frames[0][0].shape
        n = len(frames)
        yuv = None
        if have_ref:
            os.makedirs(WORK_DIR, exist_ok=True)
            yuv = os.path.join(WORK_DIR, f"{sname}.yuv")
            write_yuv(frames, yuv)
        for preset, gop_m, label in POINTS:
            key = f"{sname}/{label}"
            ours_r, ours_p, ref_r, ref_p = [], [], [], []
            ofps = rfps = 0.0
            for qp in QPS:
                b, p, f = run_ours(frames, qp, preset, gop_m, device)
                ours_r.append(b)
                ours_p.append(p)
                ofps += f / len(QPS)
                line = f"{key} qp{qp}: ours {b}B {p:.3f}dB"
                if have_ref:
                    b, p, f = run_reference(yuv, w, h, n, qp, preset, gop_m,
                                            f"{sname}_{preset}{gop_m}_{qp}")
                    ref_r.append(b)
                    ref_p.append(p)
                    rfps += f / len(QPS)
                    line += f" | ref {b}B {p:.3f}dB"
                print(line, flush=True)
            bd = (bd_rate(ref_r[::-1], ref_p[::-1], ours_r[::-1],
                          ours_p[::-1]) if have_ref else None)
            results[key] = {
                "bd_rate_pct": None if bd is None else round(bd, 2),
                "ours": {"bytes": ours_r, "psnr_y": ours_p,
                         "fps": round(ofps, 2)},
                "reference": ({"bytes": ref_r, "psnr_y": ref_p,
                               "fps": round(rfps, 2)} if have_ref else None)}
            if have_ref:
                print(f"== {key}: BD-rate {bd:+.2f}% "
                      f"(speed {ofps / max(rfps, 1e-9):.2f}x)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report(results, args.quick, have_ref))
        print(f"wrote {args.out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
