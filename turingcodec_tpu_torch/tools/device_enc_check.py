"""CLI: check of the encoder analysis stage on a torch device against its
host twins, on an in-repo input.

Decodes tests/streams/vfy_sweep.hevc with the port (md5 against
GOLDEN.json), optionally upscales it by nearest neighbour (3 gives the
1920x1080 frames of chip_smoke.py's main path), and then checks, with
exact integers:
- the seed field, the dense field and the dense sweep's SAD surface on
  the device against the native host prepass (native.dense_analysis);
- the dense-ME kernel against its plain version on the device (winners
  and surface);
- the subpel planes at 8 and 10 bits and the rank-SATD tables (their
  kernels on a card) against their numpy twins;
- an encode of the first --frames frames (4) with the stage on the
  device, byte-identical to the host path's (device=None), with one SAD
  surface installed per inter picture.
Each stage's time per picture (host clock, transfers included) is
printed beside it, and the two planes' uploads from pageable memory and
the subpel planes' and rank tables' downloads into pinned memory alone.
--turns encodes in four turns instead, with SAD surfaces and with
TC_NO_ME_SURF (on, off, off, on), on the device and on the host each
turn, and prints the frame rates.

Usage: python -m turingcodec_tpu_torch.tools.device_enc_check
           [--device {cuda,cpu}] [--upscale N] [--frames N] [--turns]

--device cuda (the default) runs the stage on the GPU and raises without
one; cpu runs the same torch code with the kernels' plain versions.
Any failed check raises.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STREAM = os.path.join(ROOT, "tests", "streams", "vfy_sweep.hevc")
GOLDEN = os.path.join(ROOT, "tests", "streams", "GOLDEN.json")


def check(cond, what) -> None:
    """Raise when a check fails (kept under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def wall_ms(fn, device, reps: int) -> float:
    """Median host-clock time of fn() in ms after a warm-up call,
    synchronised on a card (upload, compute and download as the encoder
    pays them)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def decode_inputs(n_frames: int, upscale: int, log=print):
    """Decode vfy_sweep with the port on the host path (md5 against the
    golden), and return its first n_frames, each plane upscaled by nearest
    neighbour, as int16."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=None)
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
    return [[np.kron(p.astype(np.uint8), ones).astype(np.int16)
             for p in planes] for planes in frames[:n_frames]]


def analysis_checks(orig, ref, zscan, device, reps: int = 3, log=print):
    """Every analysis stage on `device` against its host twin for one
    (orig, ref) pair of 8-bit luma planes; returns each stage's time per
    picture in ms (host clock, transfers included; none with reps 0)."""
    import torch

    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.ops.dense_me import (dense_inputs,
                                                    dense_me_argmin_ref,
                                                    dense_me_sweep)
    device = torch.device(device)
    h, w = orig.shape
    times = {}

    def timed(name, fn):
        if reps:
            times[name] = wall_ms(fn, device, reps)

    nat = native.dense_analysis(orig, ref, 8)
    check(nat is not None and nat[5] is not None,
          "native dense_analysis (with its surface) unavailable")
    sm_n, dm_n, ds_n, wb_n, hb_n, surf_n = nat
    sm, wb, hb = da.seed_field_device(orig, ref, device)
    check((wb, hb) == (wb_n, hb_n) and np.array_equal(sm, sm_n),
          "seed field differs from the native host twin")
    timed("seed_field_device", lambda: da.seed_field_device(orig, ref,
                                                            device))
    timed("the two planes' uploads", lambda: (
        da.upload(orig, device, torch.int16),
        da.upload(ref, device, torch.int16)))
    got = da.analysis_device(orig, ref, device, want_surf=True, bit_depth=8)
    check(all(np.array_equal(g, n) for g, n in zip(
        got[:3] + got[5:], (sm_n, dm_n, ds_n, surf_n))),
        "seed/dense/SAD fields or the SAD surface differ from the native "
        "host twin")
    check(all(np.array_equal(g, n) for g, n in zip(
        da.analysis_device(orig, ref, device, bit_depth=8)[:3], got[:3])),
        "the fields differ with and without the surface")
    timed("analysis_device", lambda: da.analysis_device(orig, ref, device,
                                                        bit_depth=8))
    timed("analysis_device_surf", lambda: da.analysis_device(
        orig, ref, device, want_surf=True, bit_depth=8))
    log(f"seed + dense fields and the ({got[5].shape[0]}, 289) SAD surface "
        f"{w}x{h}: equal to the native host twin")

    o = da.upload(orig, device, torch.int16)
    r = da.upload(ref, device, torch.int16)
    args = (o, r, da.seed_field(o, r), w, h, wb, hb)
    res, surf = dense_me_sweep(*args, True, bit_depth=8)
    want, want_surf = dense_me_argmin_ref(*dense_inputs(*args), True)
    check(torch.equal(res, want) and torch.equal(surf, want_surf)
          and torch.equal(dense_me_sweep(*args, bit_depth=8), want),
          "dense_me_sweep differs from its plain version")
    log(f"dense_me_sweep on {device}, winners and surface: equal to the "
        f"plain version (B={hb * wb})")

    for bd in (8, 10):
        plane = ((ref << (bd - 8)) + (orig & ((1 << (bd - 8)) - 1))
                 ).astype(np.int16)
        check(np.array_equal(da.subpel_planes_device(plane, bd, device),
                             da.subpel_planes_host(plane, bd)),
              f"{bd}-bit subpel planes differ from the numpy twin")
        log(f"subpel planes {bd}-bit: equal to the numpy twin")
        timed(f"subpel_planes_device_{bd}bit",
              lambda: da.subpel_planes_device(plane, bd, device))
    sub = da.subpel_planes(da.upload(ref, device, torch.int16), 8)
    timed("subpel_planes download", lambda: da._to_host([sub]))

    got = da.rank_satd_tables_device(orig, zscan, 8, True, device)
    want = da.rank_satd_tables_host(orig, zscan, 8, True)
    check(sorted(got) == sorted(want), "rank-SATD table sizes differ")
    for n in want:
        check(np.array_equal(got[n], want[n]),
              f"rank-SATD table n={n} differs from the numpy twin")
    log("rank-SATD tables n=4..32: equal to the numpy twin")
    timed("rank_satd_tables_device",
          lambda: da.rank_satd_tables_device(orig, zscan, 8, True, device))
    tabs = list(da.rank_satd_tables(da.upload(orig, device, torch.int16),
                                    zscan, 8, True).values())
    timed("rank_satd_tables download", lambda: da._to_host(tabs))
    for k, v in times.items():
        log(f"stage {k} per {w}x{h} picture: {v:.3f} ms "
            f"(median, host clock incl. transfers)")
    return times


def encode(frames, device, qp: int = 30, sao: bool = False):
    """Encode at bench.py's fast low-delay operating point (QP 30 unless
    given; SAO off unless given, as there); returns (bitstream,
    frames/s)."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    h, w = frames[0][0].shape
    cfg = EncoderConfig(width=w, height=h, qp=qp, rd_candidates=1,
                        search_range=32, gop_m=1, sao=sao, rdoq=True,
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


def encode_turns(frames, device, log=print):
    """The encode with the stage on `device` and on the host, with SAD
    surfaces and with TC_NO_ME_SURF, in turns (on, off, off, on); checks
    every bitstream identical and one surface per inter picture with
    surfaces. Returns {(surfaces, "device" | "host"): [frames/s, ...]}."""
    from turingcodec_tpu_torch.encode import device_analysis as da
    n_p = len(frames) - 1   # low-delay P: one IDR, then P pictures
    fps = {(s, d): [] for s in ("on", "off") for d in ("device", "host")}
    streams = set()
    for surf in ("on", "off", "off", "on"):
        if surf == "off":
            os.environ["TC_NO_ME_SURF"] = "1"
        try:
            da.surfaces = 0
            bs, f_dev = encode(frames, str(device))
            check(da.surfaces == (n_p if surf == "on" else 0),
                  f"{da.surfaces} SAD surfaces installed for {n_p} inter "
                  f"pictures, surfaces {surf}")
            bs_host, f_host = encode(frames, None)
        finally:
            os.environ.pop("TC_NO_ME_SURF", None)
        streams |= {bs, bs_host}
        fps[surf, "device"].append(f_dev)
        fps[surf, "host"].append(f_host)
    check(len(streams) == 1, "the bitstreams differ between turns")
    h, w = frames[0][0].shape
    log(f"encode {len(frames)} frames {w}x{h} fps in turns (surfaces on, "
        f"off, off, on; device={device} then host each time): " + "; ".join(
            f"surfaces {s} {d} " + " / ".join(f"{v:.4f}" for v in fps[s, d])
            for s in ("on", "off") for d in ("device", "host"))
        + f"; {n_p} surfaces per run with them, all eight bitstreams "
        f"identical")
    return fps


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch "
                                      "device_enc_check")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the default) = the GPU (raises without a "
                         "GPU), cpu = the kernels' plain torch versions")
    ap.add_argument("--upscale", type=int, default=1,
                    help="nearest-neighbour upscale of vfy_sweep's 640x360 "
                         "frames (3 gives 1920x1080)")
    ap.add_argument("--frames", type=int, default=4,
                    help="frames to encode (vfy_sweep has 8)")
    ap.add_argument("--turns", action="store_true",
                    help="encode in turns with SAD surfaces and with "
                         "TC_NO_ME_SURF, on the device and on the host")
    args = ap.parse_args(argv)

    import torch

    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    device = da.resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}")
    frames = decode_inputs(args.frames, args.upscale)
    orig, ref = frames[1][0], frames[0][0]
    h, w = orig.shape
    zscan = Encoder(EncoderConfig(width=w, height=h, qp=30,
                                  rd_candidates=1, device=None)).geom.zscan
    analysis_checks(orig, ref, zscan, device)

    if args.turns:
        encode_turns(frames, device)
        print("OK")
        return 0
    da.surfaces = 0
    got, fps = encode(frames, str(device))
    surfaces = da.surfaces
    want, fps_host = encode(frames, None)
    check(got == want, "the device encode differs from the host encode")
    print(f"encode {len(frames)} frames {w}x{h}: device={device} {fps:.4f} "
          f"fps, host {fps_host:.4f} fps, {len(got)} bytes identical, "
          f"{surfaces} SAD surfaces installed")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
