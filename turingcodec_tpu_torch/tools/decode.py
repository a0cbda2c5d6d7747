"""CLI: decode an HEVC bitstream to YUV.

Usage: python -m turingcodec_tpu_torch.tools.decode input.hevc [-o out.yuv]
           [--frames N] [--md5 EXPECTED] [--device {none,cpu,cuda}]
           [--profiler]

Parity reference: the `turing decode` subcommand (turing/decode.cpp:86,
turing/main.cpp:54-162).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch decode")
    ap.add_argument("input")
    ap.add_argument("-o", "--output-file", default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="number of frames to decode")
    ap.add_argument("--md5", default=None,
                    help="verify output YUV md5 against this hex digest")
    ap.add_argument("--no-progress", action="store_true")
    ap.add_argument("--device", choices=["none", "cpu", "cuda"],
                    default="cuda",
                    help="where the decoder's device pipeline runs: cuda (the "
                         "default) = on the GPU with the CUDA kernels "
                         "(raises without a GPU), none = host path, cpu = "
                         "the same pipeline through the kernels' plain "
                         "torch versions")
    ap.add_argument("--profiler", action="store_true",
                    help="record the trace's spans and counters and print "
                         "its per-span summary at exit")
    args = ap.parse_args(argv)
    if args.profiler:
        from turingcodec_tpu_torch.utils.profiler import TRACE
        TRACE.forced = True

    from turingcodec_tpu_torch.decode.decoder import decode_to_yuv

    data = open(args.input, "rb").read()
    t0 = time.time()
    digest, n = decode_to_yuv(
        data, max_frames=args.frames, out_path=args.output_file,
        device=None if args.device == "none" else args.device)
    dt = time.time() - t0
    if not args.no_progress:
        print(f"decoded {n} frames in {dt:.1f}s ({n / dt:.2f} fps)  "
              f"md5 {digest}", file=sys.stderr)
    if args.profiler:
        print(TRACE.report(), file=sys.stderr)
    if args.md5 is not None:
        if digest != args.md5.lower():
            print(f"MD5 MISMATCH: got {digest}, want {args.md5}",
                  file=sys.stderr)
            return 1
        print("md5 OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
