"""CLI: PSNR between two YUV 4:2:0 files (turing psnr analogue,
turing/psnr.cpp)."""
from __future__ import annotations

import argparse
import sys

import numpy as np


def yuv_psnr(a: bytes, b: bytes, w: int, h: int, bit_depth: int = 8):
    fsz = w * h * 3 // 2 * (2 if bit_depth > 8 else 1)
    n = min(len(a), len(b)) // fsz
    dt = "<u2" if bit_depth > 8 else np.uint8
    maxv = (1 << bit_depth) - 1
    stats = []
    for i in range(n):
        fa = np.frombuffer(a[i * fsz:(i + 1) * fsz], dt).astype(np.float64)
        fb = np.frombuffer(b[i * fsz:(i + 1) * fsz], dt).astype(np.float64)
        ys = w * h
        cs = w * h // 4
        res = []
        for lo, hi in ((0, ys), (ys, ys + cs), (ys + cs, ys + 2 * cs)):
            mse = ((fa[lo:hi] - fb[lo:hi]) ** 2).mean()
            res.append(10 * np.log10(maxv * maxv / mse) if mse else np.inf)
        stats.append(res)
    return np.array(stats)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch psnr")
    ap.add_argument("file_a")
    ap.add_argument("file_b")
    ap.add_argument("--input-res", required=True)
    ap.add_argument("--bit-depth", type=int, default=8)
    ap.add_argument("--per-frame", action="store_true")
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.input_res.split("x"))
    stats = yuv_psnr(open(args.file_a, "rb").read(),
                     open(args.file_b, "rb").read(), w, h, args.bit_depth)
    if args.per_frame:
        for i, (y, u, v) in enumerate(stats):
            print(f"frame {i}: Y {y:.3f}  U {u:.3f}  V {v:.3f}")
    m = stats.mean(axis=0)
    print(f"average PSNR over {len(stats)} frames: "
          f"Y {m[0]:.3f}  U {m[1]:.3f}  V {m[2]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
