"""CLI: encode raw 4:2:0 YUV to an HEVC bitstream.

Usage: python -m turingcodec_tpu_torch.tools.encode in.yuv --input-res WxH
           [-o out.hevc] [--qp N] [--frames N] [--dump-frames recon.yuv]
           [--device {none,cpu,cuda}] [--profiler]

Parity reference: the `turing encode` subcommand (turing/encode.cpp).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch encode")
    ap.add_argument("input")
    ap.add_argument("--input-res", required=True, help="<width>x<height>")
    ap.add_argument("-o", "--output-file", required=True)
    ap.add_argument("--qp", type=int, default=26)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--bit-depth", type=int, default=8)
    ap.add_argument("--dump-frames", default=None,
                    help="write reconstructed YUV here")
    ap.add_argument("--rd-candidates", type=int, default=None)
    ap.add_argument("--speed", choices=["slow", "medium", "fast"],
                    default="slow", help="preset (turing Speed.h analogue)")
    ap.add_argument("--qpg", "--max-gop-m", dest="gop_m", type=int, default=1,
                    help="mini-GOP size: 1 (low delay) / 2 / 4 / 8")
    ap.add_argument("--intra-period", type=int, default=0)
    ap.add_argument("--bitrate", type=float, default=None,
                    help="target bits/s (enables CBR rate control)")
    ap.add_argument("--frame-rate", type=float, default=24.0)
    ap.add_argument("--shot-change", action="store_true")
    ap.add_argument("--no-wpp", action="store_true")
    ap.add_argument("--hash", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--rdoq", dest="rdoq", action="store_true", default=None,
                    help="force RDOQ on (default: on at every preset)")
    ap.add_argument("--no-rdoq", dest="rdoq", action="store_false",
                    help="force RDOQ off")
    ap.add_argument("--sao", dest="sao", action="store_true", default=None,
                    help="force SAO on (default: preset; fast disables)")
    ap.add_argument("--no-sao", dest="sao", action="store_false",
                    help="force SAO off")
    ap.add_argument("--sdh", action="store_true", default=None,
                    help="sign data hiding (default: on at slow/medium, "
                         "matching the reference Speed.h useSdh)")
    ap.add_argument("--no-sdh", dest="sdh", action="store_false")
    ap.add_argument("--wp-luma", default=None, metavar="W:D:O",
                    help="explicit weighted prediction for P slices: "
                         "weight:log2_denom:offset (e.g. 59:6:0)")
    ap.add_argument("--wp-chroma", default=None, metavar="DW:DO",
                    help="chroma WP deltas (requires --wp-luma)")
    ap.add_argument("--rcudepth", action="store_true", default=None,
                    help="RCU-depth CU-range pruning (default: on at "
                         "medium/fast, matching the reference Speed.h)")
    ap.add_argument("--no-rcudepth", dest="rcudepth", action="store_false")
    ap.add_argument("--amp", action="store_true",
                    help="asymmetric motion partitions (slow preset)")
    ap.add_argument("--slices", type=int, default=1,
                    help="independent slices per picture (needs --no-wpp)")
    ap.add_argument("--dependent-slices", action="store_true",
                    help="emit slices 2..N as dependent slice segments")
    ap.add_argument("--no-progress", action="store_true")
    ap.add_argument("--rqt", dest="rqt", action="store_true", default=None,
                    help="inter one-level RQT search (default at slow)")
    ap.add_argument("--no-rqt", dest="rqt", action="store_false")
    ap.add_argument("--esd", dest="esd", action="store_true", default=None,
                    help="early skip detection (default at medium/fast)")
    ap.add_argument("--no-esd", dest="esd", action="store_false")
    ap.add_argument("--hrd-sei", action="store_true",
                    help="emit buffering_period + pic_timing CPB/DPB "
                         "delay SEIs (needs --bitrate)")
    ap.add_argument("--device", choices=["none", "cpu", "cuda"],
                    default="cuda",
                    help="where the encoder analysis stage runs: cuda (the "
                         "default) = on the GPU with the CUDA kernels "
                         "(raises without a GPU), none = host path, cpu = "
                         "the same stage through the kernels' plain "
                         "torch versions")
    ap.add_argument("--profiler", action="store_true",
                    help="record the trace's spans and counters and print "
                         "its per-span summary at exit")
    args = ap.parse_args(argv)
    if args.profiler:
        from turingcodec_tpu_torch.utils.profiler import TRACE
        TRACE.forced = True

    import numpy as np

    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig

    w, h = (int(x) for x in args.input_res.split("x"))
    presets = {  # rd_candidates, search_range (Speed.h:31-211 analogue;
        # the reference's pattern-search window is 64, 32 in fast)
        "slow": (3, 64), "medium": (2, 64), "fast": (1, 32)}
    rd, sr = presets[args.speed]
    if args.rd_candidates is not None:
        rd = args.rd_candidates
    # HM RDOQ is native and cheap here, so it defaults ON at every preset
    # (the reference enables it at slow/medium only, Speed.h useRdoq) —
    # fast+RDOQ beats the reference fast preset's BD-rate
    rdoq = args.rdoq if args.rdoq is not None else True
    sdh = args.sdh if args.sdh is not None else rdoq
    # Speed.h useSao: slow/medium only (fast runs without SAO)
    sao = args.sao if args.sao is not None else args.speed != "fast"
    cfg = EncoderConfig(width=w, height=h, qp=args.qp, sao=sao,
                        bit_depth=args.bit_depth,
                        rd_candidates=rd, search_range=sr,
                        rcudepth=args.rcudepth,
                        gop_m=args.gop_m, intra_period=args.intra_period,
                        bitrate=args.bitrate, frame_rate=args.frame_rate,
                        shot_change=args.shot_change,
                        wpp=not args.no_wpp, hash_type=args.hash,
                        rdoq=rdoq, sdh=sdh, amp=args.amp,
                        slices=args.slices,
                        dependent_slices=args.dependent_slices,
                        wp_luma=tuple(int(x) for x in args.wp_luma.split(":"))
                        if args.wp_luma else None,
                        wp_chroma=tuple(
                            int(x) for x in args.wp_chroma.split(":"))
                        if args.wp_chroma else None,
                        sei_hrd_timing=args.hrd_sei, rqt=args.rqt,
                        esd=args.esd,
                        device=None if args.device == "none"
                        else args.device)
    enc = Encoder(cfg)
    data = open(args.input, "rb").read()
    fsz = w * h * 3 // 2
    total = len(data) // fsz
    if args.frames is not None:
        total = min(total, args.frames)

    from turingcodec_tpu_torch.encode.encoder import read_yuv_frame
    out = open(args.output_file, "wb")
    out.write(enc.headers())
    t0 = time.time()
    nbytes = 0
    recons = {}
    done = 0

    def handle(results):
        nonlocal nbytes, done
        for (idx, nal, recon) in results:
            out.write(nal)
            nbytes += len(nal)
            recons[idx] = recon
            done += 1
            if not args.no_progress:
                print(f"pic {idx}: {len(nal)} bytes "
                      f"({done / (time.time() - t0):.2f} fps)",
                      file=sys.stderr)

    for i in range(total):
        handle(enc.push_frame(read_yuv_frame(data, i, w, h)))
    handle(enc.flush())
    out.close()
    if args.dump_frames:
        with open(args.dump_frames, "wb") as dump:
            for i in range(total):
                for p in recons[i]:
                    dump.write(p.astype(np.uint8).tobytes())
    if not args.no_progress:
        dt = time.time() - t0
        print(f"encoded {total} frames, {nbytes} bytes, {dt:.1f}s",
              file=sys.stderr)
    if args.profiler:
        print(TRACE.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
