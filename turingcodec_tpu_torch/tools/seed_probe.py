"""CLI: versions of the seed-field kernel's source in turns on one card.

    python -m turingcodec_tpu_torch.tools.seed_probe --src A.cu [--src B.cu]
        [--variant C.cu] [--split D.cu] [--n 50] [--json PATH]

Each --src is a csrc/seed_field.cu (its seed_field_launch ABI: orig, ref,
n, w, h, out, stream), built with ops/kernel_build.py's flags into
build/kernels (ptxas's registers and shared memory logged, and the CTAs
an SM where the source has seed_field_occupancy) and held equal to the
plain version seed_field_ref on chip_smoke.py's 1080p pair and its 7
pairs in one launch. Each --variant is a source of the same ABI that is
timed but not checked (one phase of a design, say). --split takes the
first design (commit 580f7f8's csrc/seed_field.cu) or the second (this
tree's) and builds two variants of it: its decimation alone (the shared
tiles summed and written out, so that the compiler keeps them) and its
searches alone (the tiles filled from their index, no global loads).
Then times them all in turns, first to last and back: device time per
launch (one a call) by torch.profiler, over the kernels named like
seed_field, at one 1080p pair on inputs cycled past the 50 MB L2, the
same pair again (warm) and the 7 pairs in one launch past L2. Prints
the card's name and power limit first; --json writes the times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from turingcodec_tpu_torch.tools.device_enc_check import check

# each design's decimation and searches: (decimation's first line, the
# searches' first line, the line after them, a fill of the tiles from their
# index, a checksum of the tiles that the kernel writes out)
_DESIGNS = {
    "first": (
        "    // 1. decimation into shared memory",
        "    const int warp = t >> 5, lane = t & 31;\n",
        "\n}\n\n}  // namespace\n",
        """    for (int i = t; i < kC4H * kC4W; i += kThreads)
        s_cur4[i] = (int)((i * 2654435761u) >> 22);
    for (int i = t; i < kR4H * kR4S; i += kThreads)
        s_ref4[i] = (int)(((i + 7) * 2654435761u) >> 22);
    for (int i = t; i < kC8H * kC8W; i += kThreads)
        s_cur8[i] = (int)(((i + 13) * 2654435761u) >> 22);
    for (int i = t; i < kR8H * kR8S; i += kThreads)
        s_ref8[i] = (int)(((i + 29) * 2654435761u) >> 22);
""",
        """    __shared__ int s_sum;
    if (t == 0) s_sum = 0;
    __syncthreads();
    int acc = 0;
    for (int i = t; i < kC4H * kC4W; i += kThreads) acc += s_cur4[i];
    for (int i = t; i < kR4H * kR4S; i += kThreads) acc += s_ref4[i];
    for (int i = t; i < kC8H * kC8W; i += kThreads) acc += s_cur8[i];
    for (int i = t; i < kR8H * kR8S; i += kThreads) acc += s_ref8[i];
    atomicAdd(&s_sum, acc);
    __syncthreads();
    if (t < kTX * kTY) {
        const int by = by0 + t / kTX, bx = bx0 + t % kTX;
        if (by < hb && bx < wb) {
            int32_t* dst = out + ((size_t)blockIdx.z * hb * wb
                                  + (size_t)by * wb + bx) * 2;
            dst[0] = s_sum;
            dst[1] = 0;
        }
    }"""),
    "second": (
        "    // 1. decimation",
        "    // 2. quarter-res +-8",
        "    if (t < kBlocks) {\n",
        """    for (int i = t; i < kQH * kQS; i += kThreads)
        s_qref[i] = (float)((i * 2654435761u) >> 22);
    for (int i = t; i < kHH * kHS; i += kThreads)
        s_href[i] = (float)(((i + 7) * 2654435761u) >> 22);
    for (int i = t; i < kCQH * kCQW; i += kThreads)
        s_qcur[i] = (float)(((i + 13) * 2654435761u) >> 22);
    for (int i = t; i < kCHH * kCHS; i += kThreads)
        s_hcur[i] = (float)(((i + 29) * 2654435761u) >> 22);
""",
        """    {
        float acc = 0.f;
        for (int i = t; i < kQH * kQS; i += kThreads) acc += s_qref[i];
        for (int i = t; i < kHH * kHS; i += kThreads) acc += s_href[i];
        for (int i = t; i < kCQH * kCQW; i += kThreads) acc += s_qcur[i];
        for (int i = t; i < kCHH * kCHS; i += kThreads) acc += s_hcur[i];
        const unsigned u = __float_as_uint(acc);
        atomicMin(&s_qkey[t % kBlocks], u);
        atomicMin(&s_hkey[t % kBlocks], u >> 9);
    }
    __syncthreads();

"""),
}


def split_variants(src: str) -> dict:
    """A design's source (the first, 580f7f8's, or the second) -> {name:
    source} of its two variants: its decimation alone and its searches
    alone."""
    text = open(src).read()
    for design, (dec, search, end, fill, checksum) in _DESIGNS.items():
        a, b = text.find(dec), text.find(search)
        c = text.find(end, b)
        if min(a, b, c) >= 0 and a < b < c:
            break
    else:
        raise RuntimeError(f"{src}: neither design's source")
    sync = text.rfind("    __syncthreads();\n", a, b)
    check(sync > a, f"{src}: no barrier after the decimation")
    return {"decimation alone": text[:b] + checksum + text[c:],
            "searches alone": text[:a] + fill + text[sync:]}


def build(name: str, source: str):
    """`source` compiled as kernel_build compiles csrc/seed_field.cu into
    build/kernels/libseed_probe_<name>.so; (its seed_field_launch, ptxas's
    lines)."""
    from turingcodec_tpu_torch.ops import kernel_build as kb
    os.makedirs(kb.BUILD_DIR, exist_ok=True)
    cu = os.path.join(kb.BUILD_DIR, f"seed_probe_{name}.cu")
    so = os.path.join(kb.BUILD_DIR, f"libseed_probe_{name}.so")
    with open(cu, "w") as f:
        f.write(source)
    r = subprocess.run([kb._nvcc()] + kb.NVCC_FLAGS + ["-o", so, cu],
                       capture_output=True, text=True)
    check(r.returncode == 0, f"nvcc failed for {name}:\n{r.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.seed_field_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p, p]
    lines = [ln.strip() for ln in r.stderr.splitlines()
             if "spill" in ln or ("ptxas info" in ln and "Used" in ln)]
    if hasattr(lib, "seed_field_occupancy"):
        what = ("registers", "local bytes", "shared bytes", "CTAs per SM",
                "threads", "CTAs at 1080p")
        out = (ctypes.c_int * len(what))()
        rc = lib.seed_field_occupancy(out)
        check(rc == 0, f"seed_field_occupancy: CUDA error {rc}")
        lines.append(", ".join(f"{n} {v}" for n, v in zip(what, out)))
    return fn, lines


def launch(fn, o, r):
    """One launch of `fn` on (h, w) or (n, h, w) int16 planes; the
    (n, hb, wb, 2) seeds."""
    import torch

    from turingcodec_tpu_torch.encode.device_analysis import block_dims
    h, w = o.shape[-2:]
    wb, hb = block_dims(w, h)
    n = o.shape[0] if o.dim() == 3 else 1
    out = torch.empty((n, hb, wb, 2), dtype=torch.int32, device=o.device)
    rc = fn(o.data_ptr(), r.data_ptr(), n, w, h, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"seed_field_launch: CUDA error {rc}")
    return out


def device_us(fn, n):
    """Device time per launch in us of the kernels named like seed_field
    in n calls of fn(), and their launches per call (torch.profiler over
    the n calls after a warm-up call; it may drop an event)."""
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
        if t > 0 and "seed_field" in e.key:
            us += t
            count += e.count
    check(count, "the profiler saw no seed_field kernel")
    return us / count, count / n


def cold(x, l2_bytes: int = 50 << 20):
    """Copies of the tensors x, four times the L2 in all; returns a
    function giving the next copy, call after call."""
    copies = [x] + [[t.clone() for t in x] for _ in range(
        max(1, -(-4 * l2_bytes // sum(t.nbytes for t in x))) - 1)]
    turn = [0]

    def nxt():
        turn[0] += 1
        return copies[turn[0] % len(copies)]
    return nxt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="a csrc/seed_field.cu (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="a source timed but not checked (repeatable)")
    ap.add_argument("--split", action="append", default=[],
                    help="a csrc/seed_field.cu to split (repeatable)")
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--json", help="write the times here")
    args = ap.parse_args(argv)
    import torch

    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.tools import device_enc_check as dec
    check(torch.cuda.is_available(), "no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    sources = {f"src{i}": open(s).read() for i, s in enumerate(args.src)}
    full = list(sources)
    for path in args.variant:
        sources[f"{os.path.basename(path)} (unchecked)"] = open(path).read()
    for path in args.split:
        for k, v in split_variants(path).items():
            sources[f"{k} (of {os.path.basename(path)})"] = v
    fns, report = {}, {"card": card, "sources": dict(
        zip(full, args.src)), "ptxas": {}, "us": {}}
    for i, (name, text) in enumerate(sources.items()):
        fns[name], report["ptxas"][name] = build(f"v{i}", text)
        for line in report["ptxas"][name]:
            print(f"{name}: {line}", flush=True)

    frames = dec.decode_inputs(8, 3, print)
    o = torch.from_numpy(frames[1][0]).to(dev)
    r = torch.from_numpy(frames[0][0]).to(dev)
    origs = torch.stack([torch.from_numpy(f[0]) for f in frames[1:]]).to(dev)
    refs = torch.stack([torch.from_numpy(f[0]) for f in frames[:-1]]).to(dev)
    h, w = o.shape
    wb, hb = da.block_dims(w, h)
    want = da.seed_field_ref(o, r, wb, hb)
    want_n = torch.stack([da.seed_field_ref(a, b, wb, hb)
                          for a, b in zip(origs, refs)])
    for name in full:
        got, got_n = launch(fns[name], o, r)[0], launch(fns[name], origs,
                                                        refs)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got_n, want_n),
              f"{name} differs from seed_field_ref")
        print(f"{name} ({args.src[full.index(name)]}): equal to "
              f"seed_field_ref at {w}x{h} and {len(origs)} pairs", flush=True)

    one, many = cold([o, r]), cold([origs, refs])
    cases = {f"{w}x{h} pair past L2": lambda f: launch(f, *one()),
             f"{w}x{h} pair warm": lambda f: launch(f, o, r),
             f"{len(origs)} pairs past L2": lambda f: launch(f, *many())}
    order = list(sources) + list(sources)[::-1]
    for case, call in cases.items():
        times = {}
        for name in order:
            us, per = device_us(lambda: call(fns[name]), args.n)
            times.setdefault(name, []).append(us)
            check(per > 0.9, f"{name}: {per} launches per call")
        report["us"][case] = times
        for name, ts in times.items():
            print(f"{case}: {name} " + " / ".join(f"{t:.2f}" for t in ts)
                  + " us per launch", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
