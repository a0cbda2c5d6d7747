"""CLI: the SAO kernel against an older version of its source, in turns on
one card.

    python -m turingcodec_tpu_torch.tools.sao_probe --old SRC [--n 50]

SRC is a csrc/sao.cu of the one-component design (a launch for each
component, its sao_launch taking one plane), e.g. at commit 110cc0b:
`git show 110cc0b:turingcodec_tpu_torch/csrc/sao.cu > build/sao_old.cu`.
Builds SRC with ops/kernel_build.py's flags and tables into build/kernels,
checks its output equal to this tree's kernel on every shape below, then
times both on inputs read from device memory (copies that overflow L2),
in turns old, new, new, old: device time per call by torch.profiler (the
kernels named like sao_kernel). Shapes: a vfy_sweep 640x360 SAO picture
and a picture of the 1080p SAO-coded encode (vfy_sweep's first 3 frames
upscaled 3x, encoded on the host path with SAO, as chip_smoke.py's phase
8 encodes them on the card), all three components (the old source: a
launch each; this tree: one launch), and a synthetic 1920x1080 luma plane
(one launch each). Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

from turingcodec_tpu_torch.tools.device_enc_check import check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_old(src: str):
    """SRC compiled as kernel_build compiles csrc/sao.cu; its sao_launch
    with the one-plane ABI."""
    from turingcodec_tpu_torch.ops import kernel_build as kb
    os.makedirs(kb.BUILD_DIR, exist_ok=True)
    so = os.path.join(kb.BUILD_DIR, "libsao_old.so")
    cmd = [kb._nvcc()] + kb.NVCC_FLAGS + kb._tables("sao") + ["-o", so, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    check(r.returncode == 0, f"nvcc failed for {src}:\n{r.stderr}")
    fn = ctypes.CDLL(so).sao_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p, p] + [i] * 3 + [p] * 3 + [i] + [p] * 2 + [i]
                   + [p] * 2 + [i] + [p] + [i] + [p] + [i] * 2 + [p])
    return fn


def old_frames(fn, src, ctb, bd, sub, st, sc, so, sl, tl, en, ac, at, sk):
    """The old kernel on sao_frames's arguments (one component, a bool
    across_tiles): one launch; the new planes."""
    import torch
    out = torch.empty_like(src)
    f, h, w = src.shape
    rc = fn(src.data_ptr(), out.data_ptr(), f, h, w, st.data_ptr(),
            sc.data_ptr(), so.data_ptr(), so.shape[-1], sl.data_ptr(),
            tl.data_ptr(), ctb.bit_length() - 1, en.data_ptr(),
            ac.data_ptr(), en.shape[-1], None, int(bool(at)), sk.data_ptr(),
            (4 // sub).bit_length() - 1, bd,
            torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"old sao launch: CUDA error {rc}")
    return out


def device_us(fn, n):
    """Device time per call of fn() in us, over the kernels named like
    sao_kernel, and their launches per call (torch.profiler over n calls
    after a warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = count = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0 and "sao_kernel" in e.key:
            us += t
            count += e.count
    check(count, "the profiler saw no sao_kernel")
    return us / n, count / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the older csrc/sao.cu")
    ap.add_argument("--n", type=int, default=50)
    args = ap.parse_args(argv)
    import torch

    from turingcodec_tpu_torch.ops import sao
    from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures
    from turingcodec_tpu_torch.tools import device_enc_check as dec
    from turingcodec_tpu_torch.tools import loop_filter_check as lfc
    check(torch.cuda.is_available(), "no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    old = build_old(args.old)

    def cold(x):
        copies = [x] + [[t.clone() for t in x]
                        for _ in range(-(-(200 << 20) // sum(
                            t.nbytes for t in x)) - 1)]
        turn = [0]

        def nxt():
            turn[0] += 1
            return copies[turn[0] % len(copies)]
        return nxt

    jobs = []

    def picture(name, p):
        plan, geom = p["plan"], p["geom"]
        maps = sao._picture_maps(plan, geom, dev)
        srcs = [torch.from_numpy(x).to(dev) for x in p["post"]]
        pargs = sao.sao_picture_args(plan, maps, srcs)
        nxt = cold(srcs)
        jobs.append((
            name,
            lambda: [old_frames(old, *sao.sao_ctb_args(plan, maps, c, s))
                     for c, s in enumerate(nxt())],
            lambda: sao.sao_picture_frames([s[None] for s in nxt()],
                                           *pargs[1:])))

    with open(os.path.join(ROOT, "tests", "streams", "vfy_sweep.hevc"),
              "rb") as fh:
        picture("vfy_sweep 640x360 picture, 3 components",
                next(p for p in capture_pictures(fh.read())
                     if p["sao"] is not None))
    frames = dec.decode_inputs(3, 3, print)
    bs = dec.encode(frames, None, 30, sao=True)[0]
    picture("1080p SAO-coded encode's picture 1, 3 components",
            capture_pictures(bs)[1])
    plane = lfc.tensors(lfc.sao_synthetic(np.random.default_rng(5), 1080,
                                          1920, 8, 64), dev)
    pn = cold([plane[0]])
    jobs.append(("synthetic 1920x1080 luma plane",
                 lambda: [old_frames(old, pn()[0], *plane[1:])],
                 lambda: [sao.sao_frames(pn()[0], *plane[1:])]))
    for name, fo, fn in jobs:
        a, b = fo(), fn()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{name}: the old kernel differs from this tree's")
        t = []
        for which in (fo, fn, fn, fo):
            t.append(device_us(which, args.n))
        print(f"{name}: old {t[0][0]:.2f} / {t[3][0]:.2f} us "
              f"({t[0][1]:.0f} launches), new {t[1][0]:.2f} / {t[2][0]:.2f} "
              f"us ({t[1][1]:.0f} launch) per call, in turns old, new, new, "
              f"old; outputs equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
