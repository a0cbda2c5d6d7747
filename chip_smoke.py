"""Smoke run of the PyTorch / H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain torch version on the card (the dense-ME
sweep also through its fused entry point, on odd-sized frames with seeds
at +-36, at 8, 10 and 12 bits, with and without its SAD surface), holds
every encoder analysis stage on the card against its host twin at 1080p
(tools/device_enc_check.py; the surface against the native prepass's),
then drives the main path: decode tests/streams/vfy_sweep.hevc (md5
against tests/streams/GOLDEN.json), upscale it 3x to 1920x1080, encode 8
frames at the fast low-delay operating point with the analysis stage on
the card and on the host (byte-identical bitstreams, one SAD surface
installed per inter picture), once more on the card with TC_NO_ME_SURF
(the same bytes, no surface), and decode the result hash-clean. Then the decoder's
device pipeline: every staged decode stage on the card against
its host twin (on the 1080p encode and on vfy_sweep), the two decoder
kernels against their plain versions (MC: synthetic inputs of two
reference lists with every phase, full-pel, 8 and 10 bits, and the 1080p
picture's own calls; the residual kernel: synthetic 1080p tables of every
size and mode with TUs on every edge, extreme levels, every QP at 8, 10
and 12 bits, and every inter picture's own call), vfy_sweep and
static_test (all full-pel) md5-exact through Decoder(device="cuda"), and
the 1080p encode decoded on the card equal to the host decode, every
picture through the pipeline, at most 3 MC launches per inter picture and
one residual launch per picture with coded inter TUs. After the decode
rates, one more decode times the residual stage (host clock, synchronised
around it). Then the DSP op library at one 1080p picture's block counts:
the forward transform and all-phase interpolation kernels against their
plain versions (8 and 10 bits, extreme inputs, every size and phase,
ragged batches), the torch ops on the card against the CPU,
tools/kernels.py at its defaults (the path that launches the two
kernels, and the residual kernel) and tools/testdecode.py on
tests/streams, on the card. Last,
each kernel's device time per launch at its path's shapes and the
residual stage's device time per inter picture (torch.profiler). Any failed check raises and the exit code is non-zero.

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
KERNELS = ("dense_me", "mc_block_grid", "dequant_idct", "fwd_transform",
           "interp_all_phases")
STREAM = os.path.join(ROOT, "tests", "streams", "vfy_sweep.hevc")
GOLDEN = os.path.join(ROOT, "tests", "streams", "GOLDEN.json")
N_FRAMES = 8
QP = 30
# peaks of an H100 SXM at its 700 W limit: HBM3 rate (NVIDIA's data sheet)
# and INT32 issue, 132 SMs x 64 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time an H100 SXM could take, the
    larger of the bytes over the HBM rate and the integer operations over
    the INT32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_us(fn, name: str, n: int = 50):
    """Device time per call of fn(), in us, summed over the CUDA kernels
    whose name holds `name`: torch.profiler's kernel durations over n calls
    after a warm-up call. Raises where the profiler reports no such kernel.
    Returns (us, launches per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if name in e.key and t > 0:
            total += t
            count += e.count
    check(count, f"the profiler saw no kernel named like {name!r}")
    return total / n, count / n


def dense_bound(b: int, plane_bytes: int, surf: bool = False):
    """Bound of one dense-ME sweep over b blocks: 289 x 256 absolute
    differences per block at one INT32 operation each; the two planes in,
    the seeds in and [ox, oy, sad] out, and the 289 int32 SADs per block
    with the surface."""
    return bound(2 * plane_bytes + 8 * b + 12 * b + (4 * 289 * b if surf
                                                       else 0),
                 289 * 256 * b)


def check_kernel(device, orig, ref, reps):
    """dense_me_argmin and the fused dense_me_sweep against their plain
    versions on the device: planted matches, random 10-bit, every SAD tied,
    12-bit extremes, the 1080p pair, and odd-sized synthetic frames at 8 and
    10 bits with seeds at +-36 (windows past every edge). Times the sweep at
    the 1080p pair's shape."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.ops.dense_me import (dense_inputs,
                                                    dense_me_argmin,
                                                    dense_me_argmin_ref,
                                                    dense_me_sweep)
    from turingcodec_tpu_torch.tools.device_enc_check import wall_ms

    def compare(name, cur, pat):
        got = dense_me_argmin(cur, pat)
        torch.cuda.synchronize()
        want = dense_me_argmin_ref(cur, pat)
        err = int((got.to(torch.int64) - want).abs().max()) \
            if got.numel() else 0
        check(torch.equal(got.cpu(), want.cpu()),
              f"kernel differs from its plain version: {name}")
        log(f"kernel vs plain, {name}: B={cur.shape[0]} equal")
        return err

    def compare_sweep(name, args):
        got = dense_me_sweep(*args)
        got_s, surf = dense_me_sweep(*args, True)
        torch.cuda.synchronize()
        cb, patch = dense_inputs(*args)
        want, want_s = dense_me_argmin_ref(cb, patch, True)
        check(torch.equal(got, want) and torch.equal(got_s, want)
              and torch.equal(surf, want_s)
              and torch.equal(dense_me_argmin(cb, patch), want),
              f"fused sweep differs from its plain version: {name}")
        log(f"fused sweep vs plain, {name}: B={got.shape[0]} equal, "
            f"and with its (B, 289) SAD surface")
        return max(int((got.long() - want.long()).abs().max()),
                   int((surf.long() - want_s.long()).abs().max()))

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
    errs.append(compare(
        "12-bit extremes (the largest SAD, every offset tied)",
        torch.full((64, 16, 16), 4095, dtype=torch.int32, device=device),
        torch.zeros((64, 32, 32), dtype=torch.int32, device=device)))

    for bd, (hh, ww) in ((8, (270, 477)), (10, (135, 250))):
        wb, hb = da.block_dims(ww, hh)
        o = torch.from_numpy(rng.integers(0, 1 << bd, (hh, ww)).astype(
            np.int16)).to(device)
        r = torch.roll(o, (5, -3), (0, 1)).contiguous()
        s = rng.integers(-36, 37, (hb, wb, 2)).astype(np.int32)
        s[0, 0], s[-1, -1], s[0, -1], s[-1, 0] = \
            (-36, -36), (36, 36), (36, -36), (-36, 36)
        errs.append(compare_sweep(
            f"{ww}x{hh} {bd}-bit, seeds to +-36",
            (o, r, torch.from_numpy(s).to(device), ww, hh, wb, hb)))

    h, w = orig.shape
    wb, hb = da.block_dims(w, h)
    o = da.upload(orig, device, torch.int16)
    r = da.upload(ref, device, torch.int16)
    args = (o, r, da.seed_field(o, r, wb, hb), w, h, wb, hb)
    errs.append(compare_sweep(f"{w}x{h} frame pair", args))
    ms = timed_ms(lambda: dense_me_sweep(*args), device, reps)
    plain_ms = timed_ms(lambda: dense_me_argmin_ref(*dense_inputs(*args)),
                        device, max(1, reps // 4))
    ms_s = timed_ms(lambda: dense_me_sweep(*args, True), device, reps)
    plain_ms_s = timed_ms(
        lambda: dense_me_argmin_ref(*dense_inputs(*args), True), device,
        max(1, reps // 4))
    b = hb * wb
    plane_bytes = o.numel() * o.element_size()
    bound_ms, bound_by = dense_bound(b, plane_bytes)
    bound_s = dense_bound(b, plane_bytes, True)
    log(f"dense_me_sweep at B={b}: kernel {ms:.4f} ms (median, CUDA events "
        f"around the wrapper), plain torch {plain_ms:.4f} ms; bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by})")
    log(f"dense_me_sweep with the surface at B={b}: kernel {ms_s:.4f} ms, "
        f"plain torch {plain_ms_s:.4f} ms; bound {bound_s[0] * 1e3:.2f} us "
        f"({bound_s[1]})")
    # the surface's download as the encoder pays it: (B, 289) int32 into
    # pageable host memory
    surf = dense_me_sweep(*args, True)[1]
    dl = wall_ms(lambda: surf.cpu(), device, reps)
    log(f"surface download, {surf.numel() * 4 / 1e6:.2f} MB into pageable "
        f"memory: {dl:.4f} ms (median, host clock, synchronised)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "timed": {f"dense_me_sweep at B={b}":
                      (lambda: dense_me_sweep(*args), bound_ms),
                      f"dense_me_sweep with the surface at B={b}":
                      (lambda: dense_me_sweep(*args, True), bound_s[0])},
            "kname": "dense_me"}


def main_path(frames, device):
    """The encode with the stage on the device (kernel counts read around
    it) and on the host, with SAD surfaces; then on the device with
    TC_NO_ME_SURF. Returns (dense_me launches of the first run, its
    bitstream)."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.tools.device_enc_check import encode
    n_p = len(frames) - 1   # low-delay P: one IDR, then P pictures
    reset_launches()
    da.surfaces = 0
    bitstream, fps = encode(frames, str(device), QP)
    counts = read_launches()
    surfaces = da.surfaces
    launches = counts.pop("dense_me")
    bs_host, fps_host = encode(frames, None, QP)
    os.environ["TC_NO_ME_SURF"] = "1"
    try:
        da.surfaces = 0
        bs_off = encode(frames, str(device), QP)[0]
    finally:
        os.environ.pop("TC_NO_ME_SURF", None)
    check(bitstream == bs_host, "device and host bitstreams differ")
    check(surfaces == n_p and da.surfaces == 0,
          f"{surfaces} SAD surfaces installed for {n_p} inter pictures, "
          f"{da.surfaces} with TC_NO_ME_SURF")
    check(bs_off == bitstream, "the bitstream differs with TC_NO_ME_SURF")
    check(launches >= n_p and not any(counts.values()),
          f"{launches} dense_me launches for {n_p} P pictures; {counts}")
    dec = Decoder(device=None)
    n = sum(1 for _ in dec.decode_stream(bitstream))
    check(n == len(frames) and dec.hash_failures == 0,
          f"decoded {n} frames, {dec.hash_failures} hash failures")
    h, w = frames[0][0].shape
    log(f"encode {len(frames)} frames {w}x{h}: device={device} {fps:.4f} "
        f"fps, host {fps_host:.4f} fps, {len(bitstream)} bytes identical, "
        f"{surfaces} SAD surfaces installed, the same bytes on the card "
        f"with TC_NO_ME_SURF; dense_me launches {launches} (>= {n_p} P "
        f"pictures); decoded {n} frames, 0 hash failures")
    return launches, bitstream


def build_all():
    """Every CUDA kernel (one nvcc each) and the native host core, all
    started together; logs each build time."""
    from concurrent.futures import ThreadPoolExecutor

    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.ops import kernel_build

    def job(name, fn):
        t0 = time.perf_counter()
        fn()
        return name, time.perf_counter() - t0

    jobs = [(f"csrc/{k}.cu for sm_90a",
             lambda k=k: kernel_build.build(k, force=True)) for k in KERNELS]
    jobs.append(("native host core", lambda: check(
        native.get_lib() is not None, "native host core did not build")))
    with ThreadPoolExecutor(len(jobs)) as ex:
        for name, dt in ex.map(lambda j: job(*j), jobs):
            log(f"built {name} in {dt:.1f} s")
    for k in KERNELS:
        for line in kernel_build.PTXAS.get(k, []):
            log(f"{k}: {line}")


def equal_on_card(name, got, want):
    """A kernel's output against its plain version's; returns max |diff|."""
    import torch
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got, want),
          f"kernel differs from its plain version: {name}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def decode_planes(bitstream, device):
    """Decode with the port; returns (frames' planes, decoder, seconds)."""
    import torch

    from turingcodec_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=device)
    t0 = time.perf_counter()
    frames = [f.planes for f in dec.decode_stream(bitstream)]
    if device is not None:
        torch.cuda.synchronize()
    return frames, dec, time.perf_counter() - t0


def check_decode_stages(device, streams):
    """The staged decode stages on the card against their host twins, per
    picture of each stream, by hooking the host decoder's calls (as
    tests/test_device_deblock.py does). Returns the MC calls of the picture
    with the most inter blocks, and every picture's residual call with its
    stream's name: {"mc": [args], "dq": [(stream, args)]}; the residual
    call's planes are copies taken before it ran."""
    import numpy as np

    import turingcodec_tpu_torch.decode.device_recon as dr
    import turingcodec_tpu_torch.decode.picture_recon as prm
    import turingcodec_tpu_torch.decode.recon_vec as rv
    from turingcodec_tpu_torch.ops.deblock import deblock_picture_device
    from turingcodec_tpu_torch.ops.sao import sao_picture_device

    host = (rv.reconstruct_inter_batch, prm.deblock_picture,
            prm.sao_picture, dr.mc_block_grid, dr.dequant_idct_add)
    counts = {"recon": 0, "deblock": 0, "sao": 0}
    pics = []
    residual_calls = []
    stream = [None]

    def same(what, a, b):
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"{what} differs from its host twin")
        counts[what.split("_")[0]] += 1

    def recon(plan, geom, ref_lists, planes):
        dev = [p.copy() for p in planes]
        host[0](plan, geom, ref_lists, planes)
        pics.append({"mc": []})
        dr.reconstruct_inter_device(plan, geom, ref_lists, dev, device)
        same("recon_inter_device", planes, dev)

    def deblock(plan, geom, ry, rcb, rcr):
        dev = [ry.copy(), rcb.copy(), rcr.copy()]
        host[1](plan, geom, ry, rcb, rcr)
        deblock_picture_device(plan, geom, *dev, device)
        same("deblock_picture_device", (ry, rcb, rcr), dev)

    def sao(plan, geom, planes):
        ref = host[2](plan, geom, [p.copy() for p in planes])
        same("sao_picture_device", ref,
             sao_picture_device(plan, geom, planes, device))
        return ref

    def mc(*a):
        pics[-1]["mc"].append(a)
        return host[3](*a)

    def dq(coeff, planes, table, bds):
        residual_calls.append((stream[0], (
            [c.clone() for c in coeff], [p.clone() for p in planes],
            table.copy(), tuple(bds))))
        return host[4](coeff, planes, table, bds)

    (rv.reconstruct_inter_batch, prm.deblock_picture, prm.sao_picture,
     dr.mc_block_grid, dr.dequant_idct_add) = (recon, deblock, sao, mc, dq)
    try:
        for name, data in streams:
            stream[0] = name
            frames, dec, _ = decode_planes(data, None)
            check(dec.hash_failures == 0, f"{name}: hash failures")
            log(f"staged decode stages on {name} ({len(frames)} frames): "
                f"equal to their host twins")
    finally:
        (rv.reconstruct_inter_batch, prm.deblock_picture, prm.sao_picture,
         dr.mc_block_grid, dr.dequant_idct_add) = host
    log(f"pictures compared: reconstruct_inter_device {counts['recon']}, "
        f"deblock_picture_device {counts['deblock']}, sao_picture_device "
        f"{counts['sao']}")
    check(min(counts.values()) > 0, f"a stage was never compared: {counts}")
    return {"mc": max(pics, key=lambda p: sum(a[1].numel()
                                               for a in p["mc"]))["mc"],
            "dq": residual_calls}


def residual_synthetic(rng, bd, h, w, device, extreme=False):
    """Arguments of one dequant_idct_add call on an (h, w) 4:2:0 picture:
    random level and predicted planes, and a table of disjoint TUs of every
    size and mode on every component with QPs over 0..51 + 6 * (bd - 8),
    tiling 32 x 32 cells (4 x 4 TUs where a cell crosses the right or
    bottom edge, so TUs touch both). extreme: levels of -32768, -32767,
    32767 and 0 only, and QPs at the two ends of their range."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.ops.transform import tu_kind
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    qp_max = 51 + 6 * (bd - 8)
    coeff, planes, rows = [], [], []
    for c, (hh, ww) in enumerate(shapes):
        if extreme:
            lv = rng.choice([-32768, -32767, 32767, 0], (hh, ww))
        else:
            lv = rng.integers(-300, 301, (hh, ww))
            big = rng.random((hh, ww)) < 0.02
            lv[big] = rng.integers(-32768, 32768, int(big.sum()))
        coeff.append(torch.from_numpy(lv.astype(np.int16)).to(device))
        planes.append(torch.from_numpy(rng.integers(
            0, 1 << bd, (hh, ww)).astype(np.int16)).to(device))
        for y0 in range(0, hh, 32):
            for x0 in range(0, ww, 32):
                inside = y0 + 32 <= hh and x0 + 32 <= ww
                lg = int(rng.integers(2, 6)) if inside else 2
                n = 1 << lg
                for y in range(y0, min(y0 + 32, hh - n + 1), n):
                    for x in range(x0, min(x0 + 32, ww - n + 1), n):
                        qp = (int(rng.choice([0, qp_max])) if extreme
                              else int(rng.integers(0, qp_max + 1)))
                        rows.append((x, y, qp, tu_kind(
                            c, lg, int(rng.integers(0, 3)))))
    return coeff, planes, np.array(rows, np.int32), (bd, bd, bd)


def check_decode_kernels(device, captured, reps):
    """mc_block_grid and dequant_idct against their plain versions on the
    card: synthetic inputs that reach every phase, the clamp and the
    saturation, then the captured calls (MC of a 1080p P picture, the
    residuals of every inter picture of the 1080p encode and vfy_sweep);
    times at the 1080p P picture's shapes."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.ops.inter import (mc_block_grid,
                                                 mc_block_grid_ref)
    from turingcodec_tpu_torch.ops.transform import (dequant_idct_add,
                                                     dequant_idct_add_ref)
    rng = np.random.default_rng(11)

    def up(a, dtype=np.int32):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)

    mc_errs = []
    h, w, b = 72, 104, 4096
    k = np.arange(b)
    for bd in (8, 10):
        for bs, taps, phases, what in ((4, 8, 4, "luma"),
                                       (2, 4, 8, "Cb+Cr")):
            # two lists of 3 and 2 references, in one launch
            planes = [[up(rng.integers(0, 1 << bd, (n, h, w)), np.int16)
                       for _ in range(1 if bs == 4 else 2)] for n in (3, 2)]
            where = [up([rng.integers(0, 3, b), rng.integers(0, 2, b)]),
                     up(rng.integers(-24, w + 16, (2, b))),
                     up(rng.integers(-24, h + 16, (2, b)))]
            for case, xf, yf in (
                    (f"all {phases * phases} phases",
                     [k % phases, k // phases % phases],
                     [k // phases % phases, k % phases]),
                    ("full-pel", [0 * k] * 2, [0 * k] * 2)):
                args = where + [up(xf), up(yf)]
                mc_errs.append(equal_on_card(
                    f"mc_block_grid {what} {bd}-bit {case}",
                    mc_block_grid(planes, *args, bs, taps, bd),
                    mc_block_grid_ref(planes, *args, bs, taps, bd)))
                log(f"kernel vs plain, mc_block_grid {what} of 2 lists in "
                    f"one launch, bs={bs} taps={taps} {bd}-bit: B={b}, "
                    f"{case}, windows past every edge: equal")
    for a in captured["mc"]:
        mc_errs.append(equal_on_card("mc_block_grid 1080p",
                                     mc_block_grid(*a), mc_block_grid_ref(*a)))
    log(f"kernel vs plain, mc_block_grid on the 1080p P picture's "
        f"{len(captured['mc'])} calls: equal")

    def residual(name, args):
        """The kernel and its plain version on copies of the same planes;
        returns max |diff| and the samples the kernel changed."""
        coeff, planes, table, bds = args
        got = dequant_idct_add(coeff, [p.clone() for p in planes], table, bds)
        want = dequant_idct_add_ref(coeff, [p.clone() for p in planes],
                                    table, bds)
        err = max(equal_on_card(name, g, w_) for g, w_ in zip(got, want))
        return err, sum(int((g != p).sum()) for g, p in zip(got, planes))

    dq_errs = []
    for bd in (8, 10, 12):
        for extreme in (False, True):
            args = residual_synthetic(rng, bd, 1080, 1920, device, extreme)
            err, changed = residual(f"dequant_idct synthetic {bd}-bit", args)
            dq_errs.append(err)
            check(changed, "the synthetic residuals changed nothing")
            log(f"kernel vs plain, dequant_idct {bd}-bit 1920x1080, "
                f"{len(args[2])} TUs of sizes 4..32 and modes 0..2 on 3 "
                f"components, TUs on every edge, "
                f"{'levels at -32768/-32767/32767/0, QPs at both ends' if extreme else f'QP 0..{51 + 6 * (bd - 8)}'}"
                f": equal ({changed} samples changed)")
    per_stream = {}
    for stream, args in captured["dq"]:
        dq_errs.append(residual(f"dequant_idct {stream}", args)[0])
        per_stream[stream] = per_stream.get(stream, 0) + 1
    log(f"kernel vs plain, dequant_idct on every inter picture's call: "
        f"{per_stream}: equal")

    out = {}
    p_calls = [a for st, a in captured["dq"] if st == "the 1080p encode"]
    check(captured["mc"] and p_calls, "no 1080p call captured")
    for name, big, fn, ref, errs, bnd in (
            ("mc_block_grid", max(captured["mc"], key=lambda a: (
                a[6], a[1].numel())), mc_block_grid, mc_block_grid_ref,
             mc_errs, mc_bound),
            ("dequant_idct", max(p_calls, key=lambda a: len(a[2])),
             dequant_idct_add, dequant_idct_add_ref, dq_errs,
             dequant_bound)):
        ms = timed_ms(lambda: fn(*big), device, reps)
        plain_ms = timed_ms(lambda: ref(*big), device, max(1, reps // 4))
        bound_ms, bound_by = bnd(big)
        if name == "dequant_idct":
            what = (f"{name} at the 1080p P picture's call ({len(big[2])} "
                    f"TUs)")
        else:
            what = (f"{name} at its largest 1080p call "
                    f"{(len(big[0]), len(big[0][0]), big[1].shape[1])}")
        log(f"{what}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms "
            f"(median, CUDA events around the wrapper); bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by})")
        out[name] = {
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "kname": name,
            "timed": {what: (lambda fn=fn, big=big: fn(*big), bound_ms)}}
    return out


# one 1080p picture's block count per transform size, and the windows of
# its 16x16 blocks: the DSP op library's full width
BLOCKS_1080P = {2: 129600, 3: 32400, 4: 8160, 5: 2040}


def fwd_bound(b: int, n: int, dst: bool):
    """Bound of one forward transform call over b (n, n) blocks: int32 in
    and out once; per block one n-point partial butterfly per row and per
    column (idct_ops: the forward even-odd decomposition has the same
    count), or the 4x4 DST's 16 multiply-adds per row and column."""
    per_line = 16 if dst else idct_ops(n)
    return bound(8 * b * n * n, b * 2 * n * per_line)


def interp_bound(b: int, w: int, h: int):
    """Bound of one all-phase interpolation over b windows: the int16
    windows in, the (4, 4, h, w) int32 phases out; per window the three
    horizontal phases' 8 taps over its h + 7 rows and, per output sample,
    the three vertical phases' 8 taps over four horizontal sources."""
    return bound(b * (h + 7) * (w + 7) * 2 + b * 16 * h * w * 4,
                 b * (24 * (h + 7) * w + 96 * h * w))


def cold_inputs(x, l2_bytes: int = 50 << 20):
    """A function returning, call after call, one of enough copies of x
    that together they overflow the card's 50 MB L2 cache four times: a
    kernel timed on it reads its input from device memory, as one whose
    input was not just written would (a 16.6 MB batch read again at once
    would come from L2, faster than the bound counts)."""
    copies = [x] + [x.clone() for _ in range(
        max(1, -(-4 * l2_bytes // (x.numel() * x.element_size()))) - 1)]
    turn = [0]

    def next_copy():
        turn[0] += 1
        return copies[turn[0] % len(copies)]
    return next_copy


def check_dsp_ops(device, reps):
    """The DSP op library at one 1080p picture's block counts: the forward
    transform and all-phase interpolation kernels against their plain
    versions on the card (8 and 10 bits, random and extreme inputs, every
    size, the DST, every phase), the torch ops (metrics, quantization,
    all-modes intra) on the card against the same code on the CPU; times
    and bounds of the two kernels. Returns their kernels-line rows."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.ops import inter, intra, metrics, quant
    from turingcodec_tpu_torch.ops import transform as tr
    rng = np.random.default_rng(13)

    def up(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    fwd_errs, fwd_timed, fwd_row = [], {}, None
    for bd in (8, 10):
        hi = (1 << bd) - 1
        for log2, b in BLOCKS_1080P.items():
            n = 1 << log2
            for dst in ((False, True) if log2 == 2 else (False,)):
                for extreme in (False, True):
                    if extreme:   # the HM range's ends, in a checkerboard
                        res = np.where(rng.random((b, n, n)) < 0.5, hi, -hi)
                        res[0] = hi
                    else:
                        res = rng.integers(-hi, hi + 1, (b, n, n))
                    x = up(res)
                    fwd_errs.append(equal_on_card(
                        f"fwd_transform {n}x{n} {bd}-bit dst={dst}",
                        tr.forward_transform_batch(x, bd, dst),
                        tr.forward_transform_batch_ref(x, bd, dst)))
                if bd == 8:
                    what = (f"fwd_transform {'DST' if dst else 'DCT'} "
                            f"{n}x{n} at B={b}")
                    cold = cold_inputs(x)
                    fwd_timed[what] = (
                        lambda cold=cold, dst=dst: tr.forward_transform_batch(
                            cold(), 8, dst), fwd_bound(b, n, dst)[0])
                    if log2 == 5:
                        fwd_row = (cold, b, n)
        # a batch that leaves the last thread block part-filled
        for log2 in BLOCKS_1080P:
            x = up(rng.integers(-hi, hi + 1, (1001, 1 << log2, 1 << log2)))
            fwd_errs.append(equal_on_card(
                f"fwd_transform ragged {1 << log2} {bd}-bit",
                tr.forward_transform_batch(x, bd),
                tr.forward_transform_batch_ref(x, bd)))
        log(f"kernel vs plain, fwd_transform {bd}-bit: DCT 4x4..32x32 and "
            f"DST 4x4 at {BLOCKS_1080P} and at 1001 blocks, random and "
            f"extreme residuals: equal")

    ip_errs, ip_timed = [], {}
    # the 1080p shapes, then a width that splits warps across windows and a
    # batch that leaves the last thread block part-filled
    for (w, h, b) in ((16, 16, 8160), (8, 8, 32400), (12, 20, 1001)):
        for bd in (8, 10):
            hi = (1 << bd) - 1
            for extreme in (False, True):
                if extreme:       # 0 / max checkerboards: the largest taps
                    win = np.where(rng.random((b, h + 7, w + 7)) < 0.5, hi,
                                   0)
                else:
                    win = rng.integers(0, hi + 1, (b, h + 7, w + 7))
                x = up(win, np.int16)
                ip_errs.append(equal_on_card(
                    f"interp_all_phases {w}x{h} {bd}-bit",
                    inter.interp_luma_all_phases(x, w, h, bd),
                    inter.interp_luma_all_phases_ref(x, w, h, bd)))
            if bd == 8:
                ip_timed[f"interp_all_phases {w}x{h} at B={b}"] = (
                    lambda x=x, w=w, h=h: inter.interp_luma_all_phases(
                        x, w, h), interp_bound(b, w, h)[0])
                if w == 16:
                    ip_row = (x, b, w, h)
        log(f"kernel vs plain, interp_all_phases {w}x{h} at B={b}, 8 and "
            f"10 bits, random and extreme windows, all 16 phases: equal")

    # the torch ops on the card against the same code on the CPU
    for log2, b in BLOCKS_1080P.items():
        n = 1 << log2
        a = rng.integers(0, 1024, (b, n, n))
        c = rng.integers(0, 1024, (b, n, n))
        for name, fn in (("sad_batch", metrics.sad_batch),
                         ("ssd_batch", metrics.ssd_batch),
                         ("satd_batch", lambda p, q: metrics.satd_batch(
                             p, q, 4 if n == 4 else 8))):
            got = fn(up(a), up(c))
            check(torch.equal(got.cpu(), fn(torch.from_numpy(a),
                                             torch.from_numpy(c))),
                  f"{name} {n}x{n} differs on the card")
        coeff = rng.integers(-32768, 32768, (b, n, n))
        qp = rng.integers(0, 64, b)
        rnd = rng.integers(0, 1 << 20, b)
        got = quant.quant_batch(up(coeff), up(qp), 10, log2, up(rnd))
        check(torch.equal(got.cpu(), quant.quant_batch(
            *[torch.from_numpy(np.asarray(v, np.int32))
              for v in (coeff, qp)], 10, log2,
            torch.from_numpy(rnd.astype(np.int32)))),
            f"quant_batch {n}x{n} differs on the card")
        refs = [rng.integers(0, 1024, (b, 2 * n + 1)) for _ in range(2)]
        co = rng.integers(0, 1024, b)
        got = intra.intra_predict_all_modes(up(refs[0]), up(refs[1]), up(co),
                                            n, 10)
        check(torch.equal(got.cpu(), intra.intra_predict_all_modes(
            *[torch.from_numpy(v.astype(np.int32)) for v in refs + [co]],
            n, 10)), f"intra_predict_all_modes n={n} differs on the card")
    log(f"torch ops on the card equal to the CPU at {BLOCKS_1080P} blocks: "
        f"sad/ssd/satd, quant_batch (mixed QPs), intra_predict_all_modes "
        f"(35 modes, {got.numel() * 4 / 1e6:.0f} MB at n=32)")

    rows = {}
    cold, b, n = fwd_row
    bnd = fwd_bound(b, n, False)
    rows["fwd_transform"] = dict(
        max_abs_err=max(fwd_errs), kname="fwd_transform",
        ms=timed_ms(lambda: tr.forward_transform_batch(cold(), 8), device,
                    reps),
        plain_ms=timed_ms(lambda: tr.forward_transform_batch_ref(cold(), 8),
                          device, max(1, reps // 4)),
        bound_ms=bnd[0], bound_by=bnd[1], timed={
            k: fwd_timed[k] for k in sorted(fwd_timed, key=lambda k: (
                "32x32" not in k, k))})
    x, b, w, h = ip_row
    bnd = interp_bound(b, w, h)
    rows["interp_all_phases"] = dict(
        max_abs_err=max(ip_errs), kname="interp_all_phases",
        ms=timed_ms(lambda: inter.interp_luma_all_phases(x, w, h), device,
                    reps),
        plain_ms=timed_ms(lambda: inter.interp_luma_all_phases_ref(x, w, h),
                          device, max(1, reps // 4)),
        bound_ms=bnd[0], bound_by=bnd[1], timed=ip_timed)
    for k, r in rows.items():
        log(f"{k} at its row's shape: kernel {r['ms']:.4f} ms, plain torch "
            f"{r['plain_ms']:.4f} ms (median, CUDA events around the "
            f"wrapper); bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return rows


def dsp_path(device):
    """The DSP op library's own entry points on the card: tools/kernels.py
    at its defaults (the path of the two kernels and of the residual
    kernel: counts read around it) and tools/testdecode.py on
    tests/streams. Returns the launches."""
    from turingcodec_tpu_torch.tools import kernels, testdecode
    reset_launches()
    rc = kernels.main(["--device", str(device.type)])
    launches = read_launches()
    check(rc == 0, "tools/kernels.py reported a mismatch")
    check(launches["fwd_transform"] and launches["interp_all_phases"]
          and launches["dequant_idct"]
          and not (launches["dense_me"] or launches["mc_block_grid"]),
          f"tools/kernels.py launches {launches}")
    check(testdecode.main(["--device", str(device.type)]) == 0,
          "tools/testdecode.py failed on tests/streams")
    log(f"tools/kernels.py at its defaults and tools/testdecode.py on "
        f"tests/streams, on the card: OK; launches {launches}")
    return launches


def device_times(rows):
    """Each kernel's device time per call at its main-path shapes (the
    first shape is the one its row reports), with the share of each
    shape's bound. Runs after the main paths, so that the profiler's
    tracing cannot touch their end-to-end timings."""
    for r in rows:
        for i, (what, (fn, bound_ms)) in enumerate(r.pop("timed").items()):
            us, per = device_us(fn, r["kname"])
            if i == 0:
                r["device_us"] = us
            log(f"{what}: {us:.2f} us device time per call (profiler, {per} "
                f"launches per call), {bound_ms * 1e3 / us:.1%} of its "
                f"{bound_ms * 1e3:.2f} us bound")


def mc_bound(args):
    """Bound of one mc_block_grid call, from this call's data: each distinct
    reference plane the blocks select read once (by address, so a picture in
    both lists, as in low-delay B, counts once), the motion in, every list's
    and component's predictions out; one INT32 multiply-add per filter tap
    the blocks' phases need (none for full-pel)."""
    import torch
    planes, sel, _xi, _yi, xf, yf, bs, taps, _bd = args
    span = bs + taps - 1
    b = sel.shape[1]
    nbytes = 5 * 4 * sel.numel()
    ops = 0
    read = {}
    for lx, lst in enumerate(planes):
        used = torch.unique(sel[lx].clamp(0, len(lst[0]) - 1)).tolist()
        for comp in lst:
            for r in used:
                read[comp[r].data_ptr()] = comp[r].nbytes
        fx, fy = xf[lx] != 0, yf[lx] != 0
        one_d = int((fx ^ fy).sum())
        two_d = int((fx & fy).sum())
        nbytes += len(lst) * b * bs * bs * 4
        ops += len(lst) * (one_d * bs * bs * taps
                           + two_d * (span * bs * taps + bs * bs * taps))
    return bound(nbytes + sum(read.values()), ops)


def idct_ops(n: int) -> int:
    """INT32 operations of one n-point inverse DCT by the even-odd (partial
    butterfly) decomposition, which gives the same integers as the matrix
    product: the odd half's (n/2)^2 multiply-adds, the even half's
    n/2-point transform and n adds to join them; 4 multiply-adds at n = 2."""
    return 4 if n == 2 else (n // 2) ** 2 + idct_ops(n // 2) + n


def dequant_bound(args):
    """Bound of one dequant_idct call, from its own table: per coded sample
    2 bytes of level read, 2 of predicted sample read and 2 written, and
    the table's 16 bytes per TU; one dequantizing INT32 multiply per sample
    and, for each inverse-DCT TU (mode 0), an n-point partial butterfly per
    row and per column."""
    from turingcodec_tpu_torch.ops.transform import TU_KIND, tu_fields
    _coeff, _planes, table, _bds = args
    _comp, log2, mode = tu_fields(table[:, TU_KIND])
    n = 1 << log2.astype(int)
    samples = int((n * n).sum())
    ops = samples + sum(2 * int(k) * idct_ops(int(k)) for k in n[mode == 0])
    return bound(6 * samples + 16 * len(table), ops)


def reset_launches():
    """Every kernel's launch count to 0."""
    from turingcodec_tpu_torch.ops import dense_me, inter, transform
    dense_me.launches = inter.launches = transform.launches = 0
    inter.interp_launches = transform.fwd_launches = 0


def read_launches():
    from turingcodec_tpu_torch.ops import dense_me, inter, transform
    return {"dense_me": dense_me.launches, "mc_block_grid": inter.launches,
            "dequant_idct": transform.launches,
            "fwd_transform": transform.fwd_launches,
            "interp_all_phases": inter.interp_launches}


def decode_main_path(device, frames, bitstream):
    """The decoder's device pipeline on the main path: vfy_sweep (B
    pictures, SAO) and static_test (every block full-pel) md5-exact through
    Decoder(device), then the 1080p encode decoded on the card (kernel
    counts read around this run) equal to the host decode, and the decode
    rates in turns. Returns the kernels' launches in the 1080p device
    decode and the residual stage's timing decode (residual_stage)."""
    import hashlib

    import numpy as np

    from turingcodec_tpu_torch.decode import device_pipeline as dp
    dev = str(device)

    for name in ("vfy_sweep.hevc", "static_test.hevc"):
        dp.pictures = dp.envelope_host = 0
        got, dec, _ = decode_planes(
            open(os.path.join(ROOT, "tests", "streams", name), "rb").read(),
            dev)
        md5 = hashlib.md5()
        for planes in got:
            for p in planes:
                md5.update(p.astype(np.uint8).tobytes())
        want = json.load(open(GOLDEN))[name]
        check(md5.hexdigest() == want and dec.hash_failures == 0,
              f"{name} on the card: md5 {md5.hexdigest()} != golden {want}")
        check(dp.pictures == len(got) and dp.envelope_host == 0,
              f"{name}: {dp.pictures} pictures through the pipeline, "
              f"{dp.envelope_host} on the host")
        log(f"decode {name} with device={dev}: {len(got)} frames, md5 "
            f"{want} OK, all through the pipeline")

    n = len(frames)
    dp.pictures = dp.envelope_host = 0
    # the pictures with coded inter TUs: each takes one residual launch
    tables, real_table = [], dp._residual_table
    dp._residual_table = lambda plan: tables.append(
        len(real_table(plan))) or real_table(plan)
    reset_launches()
    try:
        got, dec, t_dev = decode_planes(bitstream, dev)
    finally:
        dp._residual_table = real_table
    launches = read_launches()
    pictures, envelope = dp.pictures, dp.envelope_host
    coded = sum(1 for t in tables if t)
    want, dec_h, t_host = decode_planes(bitstream, None)
    check(len(got) == n and dec.hash_failures == 0
          and dec_h.hash_failures == 0, "1080p decode: frames or hashes")
    check(all(np.array_equal(a, b) for fa, fb in zip(got, want)
              for a, b in zip(fa, fb)),
          "1080p decode on the card differs from the host decode")
    check(pictures == n and envelope == 0,
          f"1080p: {pictures} pictures through the pipeline, {envelope} "
          f"on the host")
    # each inter picture takes one luma and one Cb+Cr launch over the lists
    # its blocks use (6 before: one per list and component)
    # one residual launch per picture with coded inter TUs (9 per inter
    # picture before: one per (component, size, mode) bucket)
    check(0 < launches["mc_block_grid"] <= 3 * (n - 1)
          and 0 < coded <= n - 1 and launches["dequant_idct"] == coded
          and launches["dense_me"] == launches["fwd_transform"]
          == launches["interp_all_phases"] == 0,
          f"launches {launches}, {coded} pictures with coded inter TUs")
    t_dev2 = decode_planes(bitstream, dev)[2]
    t_host2 = decode_planes(bitstream, None)[2]
    h, w = frames[0][0].shape
    log(f"decode {n} frames {w}x{h} with device={dev}: equal to the host "
        f"decode, 0 hash failures, {pictures} pictures through the "
        f"pipeline, 0 on the host; launches {launches}; {coded} pictures "
        f"with coded inter TUs")
    log(f"decode fps, host clock, in turns card/host/card/host: "
        f"{n / t_dev:.4f} / {n / t_host:.4f} / {n / t_dev2:.4f} / "
        f"{n / t_host2:.4f}")
    return launches, residual_stage(dev, bitstream)


def residual_stage(dev, bitstream):
    """One more card decode, after the timed ones so that it cannot touch
    them, with a sync on each side of every `_residuals_device` call: the
    residual stage's host-clock ms per picture. Returns each inter
    picture's (plan, planes as MC left them) for residual_device_us."""
    import torch

    from turingcodec_tpu_torch.decode import device_pipeline as dp
    real = dp._residuals_device
    times, pics = [], []

    def timed(plan, planes):
        pics.append((plan, [p.clone() for p in planes]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(plan, planes)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    dp._residuals_device = timed
    try:
        decode_planes(bitstream, dev)
    finally:
        dp._residuals_device = real
    log(f"residual stage, host clock with a sync on each side: "
        f"{sum(times) / len(times) * 1e3:.4f} ms per picture (mean of "
        f"{len(times)}; {', '.join(f'{t * 1e3:.3f}' for t in times)} ms)")
    return [(plan, planes) for plan, planes in pics
            if len(dp._residual_table(plan))]


def residual_device_us(pics, n: int = 20):
    """Device time of the residual stage per inter picture: every kernel
    and every copy that `_residuals_device` enqueues, by torch.profiler,
    over n passes of the captured pictures (the planes take the residual
    again on each pass: the same work). Returns (kernel us, copy us,
    kernel launches) per picture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from turingcodec_tpu_torch.decode import device_pipeline as dp
    for plan, planes in pics:
        dp._residuals_device(plan, planes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            for plan, planes in pics:
                dp._residuals_device(plan, planes)
        torch.cuda.synchronize()
    kern = copy = count = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t <= 0:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copy += t
        else:
            kern += t
            count += e.count
    per = n * len(pics)
    return kern / per, copy / per, count / per


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
    build_all()

    from turingcodec_tpu_torch.tools import device_enc_check
    frames = device_enc_check.decode_inputs(N_FRAMES, 3, log)
    orig, ref = frames[1][0], frames[0][0]
    h, w = orig.shape
    check((w, h) == (1920, 1080), f"upscaled input is {w}x{h}")

    # 3. dense-ME kernel against its plain versions on the card
    kern = check_kernel(device, orig, ref, reps=20)

    # 4. stages against their host twins (the surface against the native
    # prepass's), by tools/device_enc_check.py
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    geom = Encoder(EncoderConfig(width=w, height=h, qp=QP, rd_candidates=1,
                                 device=None)).geom
    device_enc_check.analysis_checks(orig, ref, geom.zscan, device, 5, log)

    # 5. main path: the encode
    launches, bitstream = main_path(frames, device)

    # 6. decode stages against their host twins (1080p encode, vfy_sweep)
    captured = check_decode_stages(device, [
        ("the 1080p encode", bitstream),
        ("vfy_sweep", open(STREAM, "rb").read())])

    # 7. decoder kernels against their plain versions on the card
    dec_kern = check_decode_kernels(device, captured, reps=20)

    # 8. main path: the decode on the card; then the residual stage timed
    dec_launches, res_pics = decode_main_path(device, frames, bitstream)

    # 9. the DSP op library at full width: its two kernels against their
    # plain versions, the torch ops against the CPU; then its own path,
    # tools/kernels.py, and tools/testdecode.py on the card
    dsp_kern = check_dsp_ops(device, reps=20)
    dsp_launches = dsp_path(device)

    # 10. device time per launch of each kernel at the main path's shapes
    rows = [dict(name="dense_me_argmin", source="dense_me.cu",
                 replaces="turingcodec_tpu/ops/pallas_kernels.py:71",
                 launches=launches, **kern),
            dict(name="mc_block_grid", source="mc_block_grid.cu",
                 replaces="turingcodec_tpu/ops/inter.py:66",
                 launches=dec_launches["mc_block_grid"],
                 **dec_kern["mc_block_grid"]),
            dict(name="dequant_idct", source="dequant_idct.cu",
                 replaces="turingcodec_tpu/ops/transform.py:32",
                 launches=dec_launches["dequant_idct"],
                 **dec_kern["dequant_idct"]),
            dict(name="fwd_transform", source="fwd_transform.cu",
                 replaces="turingcodec_tpu/ops/transform.py:51",
                 launches=dsp_launches["fwd_transform"],
                 **dsp_kern["fwd_transform"]),
            dict(name="interp_all_phases", source="interp_all_phases.cu",
                 replaces="turingcodec_tpu/ops/inter.py:23",
                 launches=dsp_launches["interp_all_phases"],
                 **dsp_kern["interp_all_phases"])]
    device_times(rows)
    kern_us, copy_us, per = residual_device_us(res_pics)
    log(f"residual stage on the card per inter picture of the 1080p decode "
        f"({len(res_pics)} pictures): {kern_us:.2f} us of kernels in {per} "
        f"launches, {copy_us:.2f} us of copies (profiler)")

    log(card)
    # no single PyTorch call computes any of the five functions (a
    # penalised argmin over 289 SADs, a per-block filter phase, an integer
    # dequantisation before two products, two integer products with a
    # rounding shift between them, 16 filter phases with their shifts and
    # exact-phase cases), so library_ms is null
    log(json.dumps({"kernels": [{
        "name": r["name"], "route": "cuda",
        "source": "turingcodec_tpu_torch/csrc/" + r["source"],
        "replaces": r["replaces"], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_us": r["device_us"], "bound_us": r["bound_ms"] * 1e3}
        for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
