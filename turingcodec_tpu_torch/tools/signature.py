"""CLI: golden-hash regression over encode/decode round trips (the `turing
signature` analogue, turing/signature.cpp:193-281; port of
`turingcodec_tpu/tools/signature.py`).

Decodes tests/streams/vfy_sweep.hevc (640x360, 9 frames; its md5 against
tests/streams/GOLDEN.json), re-encodes its first frames under the
configuration matrix and checks 4-byte md5 prefixes of both the bitstream
and the reconstruction against the pinned goldens, with the encoder's
recon equal to the port's decode of the stream and no hash-SEI failure.
Like the reference's asm0/threads-1 rows (signature.cpp:228-237), the
threads-1, native-off and frame-thread rows share their parent row's
goldens: output is deterministic across thread counts and across the
native/Python twins.

Usage: python -m turingcodec_tpu_torch.tools.signature
           [--device {cuda,none,cpu}] [--rows NAME,...] [--update]

--device cuda (the default) runs the encoder's analysis stage and the
decode on the GPU and raises without one; none is the host path; cpu runs
the device code through the kernels' plain versions. Every device gives
the same goldens. --update prints (and accepts) freshly measured hashes.
Exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

STREAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "streams")
STREAM = os.path.join(STREAMS, "vfy_sweep.hevc")
WIDTH, HEIGHT = 640, 360

# (name, config overrides, n_frames, env overrides, golden (bits4, recon4)
# or the name of the row whose goldens it shares). The goldens are the JAX
# package's own (turingcodec_tpu/tools/signature.py run(update=True) on
# vfy_sweep; tests/test_torch_signature.py pins them): any decision drift
# fails here first.
CONFIGS = [
    ("all-intra-q32", dict(all_intra=True, qp=32, rd_candidates=2), 2,
     {}, ("bb47fe0e", "4df21516")),
    ("lowdelay-q32", dict(qp=32, rd_candidates=2), 3,
     {}, ("ff219fb0", "2e5f452a")),
    ("lowdelay-q32-threads1", dict(qp=32, rd_candidates=2), 3,
     {"TURING_TPU_ENC_THREADS": "1"}, "lowdelay-q32"),
    ("lowdelay-q32-no-native", dict(qp=32, rd_candidates=2), 3,
     {"TURING_TPU_NO_NATIVE": "1"}, "lowdelay-q32"),
    ("gop4-q32", dict(qp=32, rd_candidates=2, gop_m=4), 5,
     {}, ("5a21d0e8", "c5631727")),
    # frame-parallel determinism: one picture at a time reproduces the
    # default (2 pictures in flight)
    ("gop4-q32-frame-seq", dict(qp=32, rd_candidates=2, gop_m=4), 5,
     {"TURING_TPU_FRAME_THREADS": "1"}, "gop4-q32"),
    # inter-picture overlap at 1 and 4 pictures in flight: the wavefront's
    # waits and the follower's band timing never change a bit
    ("overlap-q32", dict(qp=32, rd_candidates=2, sao=False,
                         frame_overlap=True), 5,
     {}, ("8f2aff57", "1d5dcb5a")),
    ("overlap-q32-seq", dict(qp=32, rd_candidates=2, sao=False,
                             frame_overlap=True),
     5, {"TURING_TPU_FRAME_THREADS": "1"}, "overlap-q32"),
    ("overlap-q32-ft4", dict(qp=32, rd_candidates=2, sao=False,
                             frame_overlap=True),
     5, {"TURING_TPU_FRAME_THREADS": "4"}, "overlap-q32"),
    # SAO under overlap: the follower's banded estimate and apply equal the
    # raster walk at any in-flight count
    ("overlap-sao-q32", dict(qp=32, rd_candidates=2, sao=True,
                             frame_overlap=True), 5,
     {}, ("3377d67c", "71c798b2")),
    ("overlap-sao-q32-seq", dict(qp=32, rd_candidates=2, sao=True,
                                 frame_overlap=True), 5,
     {"TURING_TPU_FRAME_THREADS": "1"}, "overlap-sao-q32"),
    ("no-wpp-q32", dict(qp=32, rd_candidates=2, wpp=False), 2,
     {}, ("e48133be", "d4539bc7")),
    ("sao-rdoq-q30", dict(qp=30, rd_candidates=2, sao=True, rdoq=True,
                          sdh=True), 3,
     {}, ("f6bf88be", "a6186261")),
    ("10bit-q32", dict(qp=32, rd_candidates=2, bit_depth=10), 2,
     {}, ("ea7245b3", "fc299a8a")),
    # field coding needs height % 16 == 0: the clip cropped to 640x352
    ("field-q32", dict(qp=32, rd_candidates=2, field_coding=True,
                       height=352), 2,
     {}, ("c343ebd6", "d92ecb3b")),
]
ROWS = {row[0]: row for row in CONFIGS}


def golden_md5() -> str:
    with open(os.path.join(STREAMS, "GOLDEN.json")) as f:
        return json.load(f)[os.path.basename(STREAM)]


def decode_input(n_decode_frames: int = 24, device=None):
    """The input clip: (8-bit YUV 4:2:0 bytes of its first frames, their
    md5)."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    with open(STREAM, "rb") as f:
        data = f.read()
    md5 = hashlib.md5()
    yuv = bytearray()
    for fr in Decoder(device=device).decode_stream(
            data, max_frames=n_decode_frames):
        fb = np.concatenate(
            [p.astype(np.uint8).ravel() for p in fr.planes]).tobytes()
        md5.update(fb)
        yuv += fb
    return bytes(yuv), md5.hexdigest()


def want_of(name: str, measured=None):
    """A row's goldens: its own pair, or its parent row's (from `measured`
    when given, as the update run takes them)."""
    exp = ROWS[name][4]
    if isinstance(exp, str):
        return (measured or {}).get(exp, ROWS[exp][4])
    return exp


def run_row(name: str, yuv: bytes, device=None):
    """Encode one row of the matrix from the decoded clip, with its env
    overrides, and decode the stream with the port on the same device.
    Returns (bits4, recon4, ok): ok when every decoded frame equals the
    encoder's recon and no picture hash fails."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.encode.encoder import (Encoder, EncoderConfig,
                                                      read_yuv_frame)
    _, overrides, n_frames, env, _ = ROWS[name]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        overrides = dict(overrides)
        overrides.setdefault("height", HEIGHT)
        cfg = EncoderConfig(width=WIDTH, search_range=16, device=device,
                            **overrides)
        enc = Encoder(cfg)
        stream = enc.headers()
        recons = {}
        shift = cfg.bit_depth - 8
        for i in range(n_frames):
            planes = read_yuv_frame(yuv, i, WIDTH, HEIGHT)
            if cfg.height != HEIGHT:
                planes = [np.ascontiguousarray(
                    p[:cfg.height >> (0 if k == 0 else 1)])
                    for k, p in enumerate(planes)]
            if shift:
                planes = [p << shift for p in planes]
            for (idx, nal, recon) in enc.push_frame(planes):
                stream += nal
                recons.setdefault(idx, []).append(recon)
        for (idx, nal, recon) in enc.flush():
            stream += nal
            recons.setdefault(idx, []).append(recon)
        dec = Decoder(device=device)
        ok = True
        rec_md5 = hashlib.md5()
        flat = [r for idx in sorted(recons) for r in recons[idx]]
        n = 0
        for k, f in enumerate(dec.decode_stream(stream)):
            n += 1
            ok &= k < len(flat) and all(
                np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(f.planes, flat[k]))
            ok &= f.hash_ok is not False
            dt = np.uint16 if shift else np.uint8
            rec_md5.update(np.concatenate(
                [np.asarray(p).astype(dt).ravel()
                 for p in f.planes]).tobytes())
        ok &= n == len(flat)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return hashlib.md5(stream).hexdigest()[:8], rec_md5.hexdigest()[:8], ok


def run(n_decode_frames: int = 24, update: bool = False, device="cuda",
        rows=None, log=print) -> int:
    """Decode the clip, then every row (or the named `rows`) on `device`;
    returns the number of failures (an input md5 other than GOLDEN.json's
    counts as one)."""
    yuv, md5 = decode_input(n_decode_frames, device)
    want_md5 = golden_md5()
    failures = int(md5 != want_md5)
    log(f"decode md5: {md5} "
        f"{'OK' if md5 == want_md5 else f'MISMATCH (want {want_md5})'}")
    results = {}
    for name in rows or [row[0] for row in CONFIGS]:
        bits4, rec4, ok = run_row(name, yuv, device)
        results[name] = (bits4, rec4)
        want = want_of(name, results)
        status = "OK" if ok else "RECON MISMATCH"
        if ok and not update and (bits4, rec4) != want:
            status = f"GOLDEN MISMATCH (want {want})"
        failures += status != "OK"
        log(f"{name:>24}: bits {bits4}  recon {rec4}  {status}")
    if update:
        log("\npinned goldens:")
        for name, pair in results.items():
            log(f'    "{name}": {pair},')
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch signature")
    ap.add_argument("--device", choices=["cuda", "none", "cpu"],
                    default="cuda")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names (default: all)")
    ap.add_argument("--update", action="store_true")
    args = ap.parse_args(argv)
    device = None if args.device == "none" else args.device
    if device is not None:
        from turingcodec_tpu_torch.encode.device_analysis import (
            resolve_device)
        resolve_device(device)   # raises without a usable card
    rows = args.rows.split(",") if args.rows else None
    unknown = set(rows or ()) - set(ROWS)
    if unknown:
        ap.error(f"unknown rows {sorted(unknown)}")
    return 1 if run(update=args.update, device=device, rows=rows) else 0


if __name__ == "__main__":
    sys.exit(main())
