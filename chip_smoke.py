"""Smoke run of the PyTorch / H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain torch version on the card (the dense-ME
sweep also through its fused entry point, on odd-sized frames with seeds
at +-36, at 8, 10 and 12 bits, with and without its SAD surface), holds
every encoder analysis stage on the card against its host twin at 1080p
(tools/device_enc_check.py; the surface against the native prepass's),
and the stage's rank-SATD and subpel kernels against their plain versions
(the 1080p I and P pictures at 8, 10 and 14 bits, strong smoothing on and
off, 0/top checkerboards at 8 and 10 bits, 1912x1064, 1916x1080 and
1913x1064 crops, the picture at an odd element of its buffer; the subpel
planes at 8, 10 and 16 bits), then drives the main path:
decode tests/streams/vfy_sweep.hevc (md5 against
tests/streams/GOLDEN.json), upscale it 3x to 1920x1080, encode 8 frames
at the fast low-delay operating point with the analysis stage on the card
and on the host (byte-identical bitstreams, one SAD surface installed per
inter picture, the rank kernel at four sizes on every picture and the
subpel kernel on every inter picture), once more on the card with
TC_NO_ME_SURF (the same bytes, no surface), and decode the result
hash-clean. Then the decoder's
device pipeline: every staged decode stage on the card against
its host twin (on the 1080p encode and on vfy_sweep), the two decoder
kernels against their plain versions (MC: synthetic inputs of two
reference lists with every phase, full-pel, 8, 10, 13 and 14 bits, and
the 1080p picture's own calls; the residual kernel: synthetic 1080p
tables of every size and mode with TUs on every edge, extreme levels,
every QP at 8, 10, 12, 13, 14 and 16 bits, and every inter picture's own
call; the deblocking kernel on synthetic 1920x1080 pictures at 8, 10,
12, 13, 14 and 16 bits and on every picture of tests/streams, the SAO
kernel on synthetic pictures at 8 to 16 bits and CTB 16, 32 and 64
(mixed depths, ragged sides, monochrome, 300 slices) and on every SAO
picture of tests/streams, each through the three-component and the
one-component launches, by tools/loop_filter_check.py; at 16 bits the
int16 samples above 32767 wrap, as the JAX pipeline holds them),
vfy_sweep and static_test (all full-pel) md5-exact through
Decoder(device="cuda") with one deblocking launch per picture and one
SAO launch per SAO-coded picture, and the 1080p encode decoded on the
card equal to the host decode, every picture through the pipeline, at
most 3 MC launches per inter picture, one residual launch per picture
with coded inter TUs, one deblocking launch per picture and no SAO.
After the decode rates, one more decode with TURING_TPU_PIPELINE_TRACE
gives each stage's ms per picture, and one more times the residual stage
(host clock, synchronised around it). Then the main path's first 3
frames encoded with SAO on (the encoder's default) on the card and the
host (identical bytes), decoded on the card equal to the host with one
SAO launch per picture, its SAO stage traced; the SAO kernel's row is
timed on that stream's picture 1. Then a 13-bit stream (tools/deep_bits.py)
decoded on the card to the JAX pipeline's md5 through the MC, residual
and deblocking kernels, and its 14- and 16-bit twins raising the
reference's error. Then the DSP op library at one 1080p
picture's block counts:
the forward transform and all-phase interpolation kernels against their
plain versions (8 and 10 bits, and 14 for the interpolation, extreme
inputs, every size and phase, 4x8 to 64x64 windows, ragged batches), the
torch ops on the card against the CPU,
tools/kernels.py at its defaults (the path that launches the two
kernels, and the residual kernel) and tools/testdecode.py on
tests/streams, on the card. Then the encoder's configuration matrix
(tools/signature.py, 15 rows, the 10-bit one included) on the card
against the goldens pinned from the JAX package; the encoder's tool
configurations (tools/tool_matrix.py: AQ per CTB and per CU, CBR at CTU
and picture level with HRD signalling, shot change, a 2x2 tile grid, 4
independent and 4 dependent slices, transform skip; on the 1080p frames,
a 640x360 scene with a cut and a 128x256 crop) encoded on the card and
the host, identical and equal to the JAX package's pinned goldens, each
reaching its tool, decoded on the card equal to the host decode with
every picture through the pipeline, one deblocking launch per picture
and one SAO launch per SAO-coded picture; 36 bit flips of vfy_sweep
(tools/bitflip.py) decoded on the card, each ending as the host decode
does, with no CUDA error; the GOP-batched stages
at 1080p on the 8-frame encode (analysis_step over 8 x 2040 blocks, MC
of the 7 inter pictures in one launch, the residuals of every coded luma
TU, deblocking of the 8 pictures in one launch, SAO of vfy_sweep's
pictures in one launch per component, the batched seed and dense
analysis of 7 pairs) against per-frame calls on the card and their plain
versions or host twins; tools/scaling.py, bdrate's run_ours on vfy_sweep
at its four QPs (identical bytes on the card and the host) and
entry.dryrun on the card. The dense-ME sweep is also held at 14 bits
(its 64-bit key) on 1080p planes whose costs straddle 2^23. Last, each
kernel's device time per launch at its path's shapes, the kernels and
device time of each batched stage against its per-frame calls, and the
residual stage's device time per inter picture (torch.profiler). Every
kernel's launches are read around each path that runs it. Any failed
check raises and the exit code is non-zero.

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
           "interp_all_phases", "rank_satd", "subpel_planes", "deblock", "sao")
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
    whose name holds `name`: torch.profiler's durations over n calls after
    a warm-up call. Raises where the profiler reports no kernel named like `name`.
    Returns (us, launches of that kernel per call)."""
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
        if t > 0 and name in e.key:
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
        got = dense_me_argmin(cur, pat, bit_depth=12)
        torch.cuda.synchronize()
        want = dense_me_argmin_ref(cur, pat)
        err = int((got.to(torch.int64) - want).abs().max()) \
            if got.numel() else 0
        check(torch.equal(got.cpu(), want.cpu()),
              f"kernel differs from its plain version: {name}")
        log(f"kernel vs plain, {name}: B={cur.shape[0]} equal")
        return err

    def compare_sweep(name, args, bd):
        got = dense_me_sweep(*args, bit_depth=bd)
        got_s, surf = dense_me_sweep(*args, True, bit_depth=bd)
        torch.cuda.synchronize()
        cb, patch = dense_inputs(*args)
        want, want_s = dense_me_argmin_ref(cb, patch, True)
        check(torch.equal(got, want) and torch.equal(got_s, want)
              and torch.equal(surf, want_s)
              and torch.equal(dense_me_argmin(cb, patch, bit_depth=bd),
                              want),
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
            (o, r, torch.from_numpy(s).to(device), ww, hh, wb, hb), bd))

    h, w = orig.shape
    wb, hb = da.block_dims(w, h)
    o = da.upload(orig, device, torch.int16)
    r = da.upload(ref, device, torch.int16)
    args = (o, r, da.seed_field(o, r, wb, hb), w, h, wb, hb)
    errs.append(compare_sweep(f"{w}x{h} frame pair", args, 8))
    wide = wide_key(device, w, h, compare_sweep)
    errs.append(wide["err"])
    ms = timed_ms(lambda: dense_me_sweep(*args, bit_depth=8), device, reps)
    plain_ms = timed_ms(lambda: dense_me_argmin_ref(*dense_inputs(*args)),
                        device, max(1, reps // 4))
    ms_s = timed_ms(lambda: dense_me_sweep(*args, True, bit_depth=8),
                    device, reps)
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
    surf = dense_me_sweep(*args, True, bit_depth=8)[1]
    dl = wall_ms(lambda: surf.cpu(), device, reps)
    log(f"surface download, {surf.numel() * 4 / 1e6:.2f} MB into pageable "
        f"memory: {dl:.4f} ms (median, host clock, synchronised)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "timed": {f"dense_me_sweep at B={b}":
                      (lambda: dense_me_sweep(*args, bit_depth=8), bound_ms),
                      f"dense_me_sweep with the surface at B={b}":
                      (lambda: dense_me_sweep(*args, True, bit_depth=8),
                       bound_s[0]),
                      f"dense_me_sweep 14-bit (64-bit key) at B={b}":
                      (wide["fn"], bound_ms)},
            "kname": "dense_me"}


def wide_key(device, w, h, compare_sweep):
    """dense_me above 12 bits: 14-bit planes at one picture's size whose
    winning costs straddle 2^23 (sources in the upper half of the range,
    references in the lower), the 64-bit key against the plain version
    (winners and surface); the 32-bit instance, given the same planes
    against its contract, to show what the key repairs (its first
    differing block is logged). Returns the max |diff| and a timed call."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.ops.dense_me import (dense_inputs,
                                                    dense_me_argmin_ref,
                                                    dense_me_sweep)
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.integers(8192, 16384, (h, w)).astype(
        np.int16)).to(device)
    r = torch.from_numpy(rng.integers(0, 8192, (h, w)).astype(
        np.int16)).to(device)
    wb, hb = da.block_dims(w, h)
    args = (o, r, da.seed_field(o, r, wb, hb), w, h, wb, hb)
    err = compare_sweep(f"{w}x{h} 14-bit, costs across 2^23", args, 14)
    want = dense_me_argmin_ref(*dense_inputs(*args))
    cost = (want[:, 2].long() << 2) + want[:, :2].abs().sum(1)
    narrow = dense_me_sweep(*args, bit_depth=12)
    bad = (narrow != want).any(1).nonzero()[:, 0]
    first = (f"block {int(bad[0])}: [ox, oy, sad] {narrow[bad[0]].tolist()} "
             f"against {want[bad[0]].tolist()}" if len(bad) else "none")
    log(f"dense_me 64-bit key, {w}x{h} 14-bit: equal to the plain version "
        f"(winning costs {int(cost.min())}..{int(cost.max())}, 2^23 = "
        f"{1 << 23}); the 32-bit instance on the same planes differs in "
        f"{len(bad)} of {want.shape[0]} blocks, first {first} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"err": err, "fn": lambda: dense_me_sweep(*args, bit_depth=14)}


def subpel_bound(h: int, w: int):
    """Bound of one subpel_planes call on an (h, w) plane: the int16 plane
    in, the (15, h + 56, w + 56) int16 planes out; the three horizontal
    phases' 8 taps over the h + 63 source rows of every output column, and
    per output sample the three vertical phases' 8 taps over the plane and
    over each of the three horizontal phases."""
    ph, pw = h + 56, w + 56
    return bound(2 * h * w + 15 * 2 * ph * pw,
                 24 * (ph + 7) * pw + 12 * 8 * ph * pw)


def rank_ops(h: int, w: int, bd: int, sizes=(4, 8, 16, 32)) -> int:
    """INT32 operations of the rank tables of an (h, w) bd-bit plane at
    `sizes`, per sample of each block and mode, a multiply-add counted once
    (one IMAD) as subpel_bound counts a tap: the angular prediction's two
    multiply-adds (the rounding folded into the first, 32 - fr hoisted per
    row) and a shift, planar's four multiply-adds and a shift, DC none;
    then the difference, the two butterfly passes (log2 of the sub-block's
    side adds each: 6 for 8x8, 4 for 4x4) and the absolute value and sum.
    Where two modes' differences fit one word for the butterflies (8x8
    sub-blocks up to 9 bits, 4x4 up to 11: every Hadamard output of a
    difference fits in int16), a butterfly on a packed pair counts once,
    half a butterfly per mode."""
    ops = 0
    for n in sizes:
        samples = (h // n) * (w // n) * n * n
        sb = 8 if n >= 8 else 4
        fly = 6 if sb == 8 else 4
        packed = bd <= (9 if sb == 8 else 11)
        ops += samples * (33 * 3 + 5 + 35 * (1 + 2)
                          + 35 * fly / (2 if packed else 1))
    return int(ops)


def rank_bound(h: int, w: int, bd: int, sizes=(4, 8, 16, 32)):
    """Bound of one rank_satd_tables call at `sizes`: the int16 plane and
    the int32 z-scan table in once (per call), the (h/n, w/n, 35) int32
    tables out; rank_ops' operations."""
    tables = sum((h // n) * (w // n) * 35 * 4 for n in sizes)
    return bound(2 * h * w + 4 * (h // 4) * (w // 4) + tables,
                 rank_ops(h, w, bd, sizes))


def check_analysis_kernels(device, frames, zscan, reps):
    """The encoder analysis stage's rank-SATD and subpel kernels against
    their plain versions on the card: the rank tables of the 1080p I and P
    pictures at 8, 10 and 14 bits with strong smoothing on and off, of 0/top
    checkerboards at 8 and 10 bits, of crops whose sides are no multiple
    of 16 or whose width is 4 mod 8 or odd, and of the picture at an odd
    element of its buffer; the
    subpel planes of the reference at 8, 10 and 16 bits (above 32767 the
    int16 samples wrap, as in the reference), of its crops of a width 4
    mod 8 and odd and of 5x9 and 1x1 (the kernel's threads store where the
    TMA cannot), of 8x8 and 64x40 (the TMA's stores, smaller than one
    tile), and of samples over the whole int16 range at 8 and 12 bits.
    Times both at 8 bits on
    inputs read from device memory, the rank tables also one size at a
    time. Returns their kernels-line rows."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.encode import device_analysis as da

    def deep(plane, other, bd):
        # the picture in the high bits, another picture's in the low ones
        return (((plane.astype(np.int64) << (bd - 8))
                 + (other & ((1 << (bd - 8)) - 1)))
                .astype(np.uint16).view(np.int16))

    pics = {"I": frames[0][0], "P": frames[1][0]}
    h, w = pics["I"].shape
    rank_errs, sub_errs = [], []
    for name, pic in pics.items():
        for bd in (8, 10, 14):
            x = torch.from_numpy(deep(pic, pics["I"] if name == "P"
                                      else pics["P"], bd)).to(device)
            for strong in (True, False):
                got = da.rank_satd_tables(x, zscan, bd, strong)
                want = da.rank_satd_tables_ref(x, zscan, bd, strong)
                check(list(got) == list(want) == [4, 8, 16, 32],
                      f"rank table sizes {list(got)}")
                rank_errs += [equal_on_card(
                    f"rank_satd {name} picture {bd}-bit strong={strong} "
                    f"n={n}", got[n], want[n]) for n in want]
    log(f"kernel vs plain, rank_satd on the 1080p I and P pictures at 8, "
        f"10 and 14 bits, strong smoothing on and off, n = 4..32: equal")
    # the largest differences the packed butterflies meet: 0/top
    # checkerboards of 1, 4 and 8 samples a square, at 8 bits (8x8 and 4x4
    # sub-blocks packed) and 10 (4x4 packed)
    yy, xx = np.indices((h, w))
    for bd in (8, 10):
        for cell in (1, 4, 8):
            x = torch.from_numpy((((yy // cell + xx // cell) % 2)
                                  * ((1 << bd) - 1)).astype(np.int16)).to(
                                      device)
            got = da.rank_satd_tables(x, zscan, bd, True)
            want = da.rank_satd_tables_ref(x, zscan, bd, True)
            rank_errs += [equal_on_card(
                f"rank_satd {bd}-bit checkerboard {cell} n={n}", got[n],
                want[n]) for n in want]
    # crops with the z-scan of their sides rounded up to 8 (the encoder's
    # geometry): sides no multiple of 32 (nor of 16); then rows that
    # 16-byte loads cannot take (a width of 4 mod 8, an odd width) and a
    # plane at an odd element of its buffer, which the kernel loads a
    # sample at a time
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    for ho, wo, offset in ((h - 16, w - 8, 0), (h, w - 4, 0),
                           (h - 16, w - 7, 0), (h, w, 1)):
        zo = Encoder(EncoderConfig(width=-(-wo // 8) * 8,
                                   height=-(-ho // 8) * 8, qp=QP,
                                   device=None)).geom.zscan
        crop = torch.from_numpy(np.ascontiguousarray(
            pics["P"][:ho, :wo])).to(device)
        buf = torch.empty(ho * wo + offset, dtype=torch.int16,
                          device=device)
        x = buf[offset:].view(ho, wo)
        x.copy_(crop)
        got = da.rank_satd_tables(x, zo, 8, True)
        want = da.rank_satd_tables_ref(x, zo, 8, True)
        rank_errs += [equal_on_card(
            f"rank_satd {wo}x{ho} at element {offset} n={n}", got[n],
            want[n]) for n in want]
    log(f"kernel vs plain, rank_satd on 0/top checkerboards (squares of 1, "
        f"4 and 8) at 8 and 10 bits, on {w - 8}x{h - 16}, {w - 4}x{h} and "
        f"{w - 7}x{h - 16} crops and on the picture at an odd element of "
        f"its buffer: equal")
    for bd in (8, 10, 16):
        x = torch.from_numpy(deep(pics["I"], pics["P"], bd)).to(device)
        sub_errs.append(equal_on_card(
            f"subpel_planes {bd}-bit", da.subpel_planes(x, bd),
            da._subpel_planes(x.to(torch.int32), bd)))
        # the kernel's second store path, where the padded width is no
        # multiple of 8 (widths 4 mod 8 and odd), and planes smaller than
        # one tile on both paths (9x5 and 1x1 on the threads' stores, 8x8
        # and 64x40 on the TMA's)
        for ho, wo in ((h, w - 4), (h - 16, w - 7), (9, 5), (1, 1), (8, 8),
                       (40, 64)):
            xo = x[:ho, :wo].contiguous()
            sub_errs.append(equal_on_card(
                f"subpel_planes {wo}x{ho} {bd}-bit", da.subpel_planes(xo, bd),
                da._subpel_planes(xo.to(torch.int32), bd)))
    # samples over the whole int16 range at 8 and 12 bits
    wild = torch.from_numpy(np.random.default_rng(9).integers(
        -32768, 32768, (h, w)).astype(np.int16)).to(device)
    wild[:, : w // 2] = x[:, : w // 2] & 255
    for bd in (8, 12):
        sub_errs.append(equal_on_card(
            f"subpel_planes {bd}-bit, samples over the int16 range",
            da.subpel_planes(wild, bd),
            da._subpel_planes(wild.to(torch.int32), bd)))
    log(f"kernel vs plain, subpel_planes of the 1080p reference at 8, 10 "
        f"and 16 bits, all 15 planes, and of its {w - 4}x{h}, "
        f"{w - 7}x{h - 16}, 5x9 and 1x1 crops (the threads' own stores) and "
        f"8x8 and 64x40 crops (the TMA's, smaller than one tile), and of "
        f"samples over the int16 range at 8 and 12 bits: equal")

    x = torch.from_numpy(np.ascontiguousarray(pics["P"])).to(device)
    cold = cold_inputs(x)
    rows = {}
    bnd = rank_bound(h, w, 8)
    rows["rank_satd"] = dict(
        max_abs_err=max(rank_errs), kname="rank_satd",
        ms=timed_ms(lambda: da.rank_satd_tables(cold(), zscan, 8, True),
                    device, reps),
        plain_ms=timed_ms(lambda: da.rank_satd_tables_ref(
            cold(), zscan, 8, True), device, max(1, reps // 4)),
        bound_ms=bnd[0], bound_by=bnd[1], timed={
            f"rank_satd at {w}x{h}, n = 4..32": (
                lambda: da.rank_satd_tables(cold(), zscan, 8, True), bnd[0])})
    # each size alone: one launch each
    for n in da.RANK_SIZES:
        ms = timed_ms(lambda n=n: da.rank_satd_tables(
            cold(), zscan, 8, True, sizes=(n,)), device, reps)
        b = rank_bound(h, w, 8, (n,))
        log(f"rank_satd at {w}x{h}, n = {n} alone: kernel {ms:.4f} ms "
            f"(median, CUDA events around the wrapper); bound "
            f"{b[0] * 1e3:.2f} us ({b[1]})")
        rows["rank_satd"]["timed"][f"rank_satd at {w}x{h}, n = {n} alone"] = (
            lambda n=n: da.rank_satd_tables(cold(), zscan, 8, True,
                                            sizes=(n,)), b[0])
    bnd = subpel_bound(h, w)
    rows["subpel_planes"] = dict(
        max_abs_err=max(sub_errs), kname="subpel_planes",
        ms=timed_ms(lambda: da.subpel_planes(cold(), 8), device, reps),
        plain_ms=timed_ms(lambda: da._subpel_planes(
            cold().to(torch.int32), 8), device, max(1, reps // 4)),
        bound_ms=bnd[0], bound_by=bnd[1], timed={
            f"subpel_planes at {w}x{h}": (
                lambda: da.subpel_planes(cold(), 8), bnd[0])})
    for k, r in rows.items():
        log(f"{k} at {w}x{h}: kernel {r['ms']:.4f} ms, plain torch "
            f"{r['plain_ms']:.4f} ms (median, CUDA events around the "
            f"wrapper); bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return rows


def main_path(frames, device):
    """The encode with the stage on the device (kernel counts read around
    it) and on the host, with SAD surfaces; then on the device with
    TC_NO_ME_SURF. Returns (the kernels' launches in the first run, its
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
    enc_launches = dict(counts)
    launches = counts.pop("dense_me")
    # the rank tables of every picture (one launch per size), the subpel
    # planes of every inter picture (both lists hold one reference)
    rank, subpel = counts.pop("rank_satd"), counts.pop("subpel_planes")
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
    check(rank == 4 * len(frames) and subpel == n_p,
          f"{rank} rank_satd launches for {len(frames)} pictures at 4 "
          f"sizes, {subpel} subpel_planes launches for {n_p} P pictures")
    dec = Decoder(device=None)
    n = sum(1 for _ in dec.decode_stream(bitstream))
    check(n == len(frames) and dec.hash_failures == 0,
          f"decoded {n} frames, {dec.hash_failures} hash failures")
    h, w = frames[0][0].shape
    log(f"encode {len(frames)} frames {w}x{h}: device={device} {fps:.4f} "
        f"fps, host {fps_host:.4f} fps, {len(bitstream)} bytes identical, "
        f"{surfaces} SAD surfaces installed, the same bytes on the card "
        f"with TC_NO_ME_SURF; dense_me launches {launches} (>= {n_p} P "
        f"pictures), rank_satd {rank} (4 sizes x {len(frames)} pictures), "
        f"subpel_planes {subpel} ({n_p} P pictures); decoded {n} frames, "
        f"0 hash failures")
    return enc_launches, bitstream


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


def occupancy():
    """The subpel, deblocking and SAO kernels' resources as the card's
    runtime reports them (their <name>_occupancy entry points): registers and
    spilled bytes a thread, shared bytes and threads a CTA, CTAs an SM,
    and CTAs launched at 1080p."""
    import ctypes

    from turingcodec_tpu_torch.ops import kernel_build
    what = ("registers", "local bytes", "shared bytes", "CTAs per SM",
            "threads", "CTAs at 1080p")
    for k in ("subpel_planes", "deblock", "sao"):
        out = (ctypes.c_int * len(what))()
        rc = getattr(kernel_build.load(k), f"{k}_occupancy")(out)
        check(rc == 0, f"{k}_occupancy: CUDA error {rc}")
        log(f"{k}: " + ", ".join(f"{n} {v}" for n, v in zip(what, out)))


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
    # 13 and 14 bits: the full-pel shift 14 - bd at 1 and 0 (negative at
    # 15 and 16, where the pipeline raises before it combines)
    for bd in (8, 10, 13, 14):
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
    # 16 bits under the int16 convention: predicted samples above 32767
    # wrap, as the JAX pipeline holds them
    for bd in (8, 10, 12, 13, 14, 16):
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


def deblock_bound(args):
    """Bound of one deblocking call, from its own inputs: the three int16
    planes read once and written once (the kernel itself reads its input
    planes and writes new ones, once each), every map and per-slice vector
    read once; 20 INT32 operations per 4-line edge segment of the two
    directions for its edge flag and bS (the filters' arithmetic, on the
    segments that pass, is less than the bytes' time whatever the data)."""
    planes, maps, sl = args[:3], args[3], args[4]
    h, w = planes[0].shape[-2:]
    f = planes[0].shape[0]
    segments = f * ((w // 8 - 1) * (h // 4) + (h // 8 - 1) * (w // 4))
    nbytes = (2 * sum(p.nbytes for p in planes)
              + sum(t.nbytes for t in maps + sl))
    return bound(nbytes, 20 * segments)


def sao_bound(args):
    """Bound of one SAO call, from its own inputs (sao_frames's or
    sao_picture_frames's): each int16 plane of the call read once and
    written once, the per-CTB maps, per-slice flags and skip map read
    once; 10 INT32 operations per sample (the band or edge index, the
    offset and the clip)."""
    planes = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
    maps = [a for a in args[4:] if hasattr(a, "nbytes")]
    return bound(2 * sum(p.nbytes for p in planes)
                 + sum(a.nbytes for a in maps),
                 10 * sum(p.numel() for p in planes))


def check_loop_filters(device, bitstream, reps):
    """The deblocking and SAO kernels against their plain versions on the
    card (tools/loop_filter_check.py: synthetic 1920x1080 pictures at 8,
    10, 12, 13, 14 and 16 bits, synthetic SAO pictures at 8 to 16 bits and
    every CTB size through the three-component and the one-component
    launches, every picture of tests/streams); then deblocking timed on
    inputs read from device memory at a 1080p picture of the main path's
    encode. Returns (deblock's kernels-line row, SAO's max |diff|)."""
    import torch

    from turingcodec_tpu_torch.ops import deblock as db
    from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures
    from turingcodec_tpu_torch.tools import loop_filter_check as lfc
    t0 = time.perf_counter()
    errs, names = lfc.check_kernels(device, log)
    log(f"loop-filter kernels checked on {len(names['deblock'])} "
        f"deblocking and {len(names['sao'])} SAO cases "
        f"({time.perf_counter() - t0:.1f} s)")

    pic = capture_pictures(bitstream, max_frames=2)[1]
    plan, geom, sps = pic["plan"], pic["geom"], pic["plan"].sps
    geo = (int(sps.ctb_log2_size_y), int(sps.bit_depth_y),
           int(sps.bit_depth_c))
    one = db.plan_tensors(plan, geom, device)
    planes = [torch.from_numpy(p).to(device) for p in pic["pre"]]
    args = (*(p[None] for p in planes), tuple(m[None] for m in one[0]),
            tuple(v[None] for v in one[1]))
    copies = [args] + [(*(p.clone() for p in args[:3]),
                        tuple(m.clone() for m in args[3]),
                        tuple(v.clone() for v in args[4]))
                       for _ in range(-(-(200 << 20) // sum(
                           t.nbytes for t in args[:3] + args[3] + args[4]))
                           - 1)]
    turn = [0]

    def cold_deblock():
        turn[0] += 1
        return copies[turn[0] % len(copies)]
    bnd = deblock_bound(args)
    h, w = planes[0].shape
    row = dict(
        max_abs_err=errs["deblock"], kname="deblock",
        ms=timed_ms(lambda: db.deblock_frames(*cold_deblock(), *geo,
                                              one[2]), device, reps),
        plain_ms=timed_ms(lambda: db.deblock_device_ref(
            *(p[0] for p in cold_deblock()[:3]), one[0], one[1], *geo,
            one[2]), device, max(1, reps // 4)),
        bound_ms=bnd[0], bound_by=bnd[1], timed={
            f"deblock at the {w}x{h} encode's picture 1": (
                lambda: db.deblock_frames(*cold_deblock(), *geo, one[2]),
                bnd[0])})
    log(f"deblock at its row's shape: kernel {row['ms']:.4f} ms, plain "
        f"torch {row['plain_ms']:.4f} ms (median, CUDA events around the "
        f"wrapper); bound {row['bound_ms'] * 1e3:.2f} us "
        f"({row['bound_by']})")
    return row, errs["sao"]


def sao_row(device, pic, err, reps):
    """The SAO kernel's kernels-line row, on inputs read from device
    memory: one launch for the three components of a picture of the 1080p
    SAO-coded encode (the row's shape: its ms, plain version and bound),
    beside the same picture by one launch per component (sao_frames, as
    gop_sao calls it), a vfy_sweep 640x360 picture both ways, and a
    synthetic 1080p luma plane (the shape the one-component design was
    timed on)."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.ops import sao
    from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures
    from turingcodec_tpu_torch.tools import loop_filter_check as lfc

    def picture(p):
        """(one launch, one launch per component, the plain version, the
        bound, 'WxH') for captured picture p, each on cold planes"""
        plan, geom = p["plan"], p["geom"]
        maps = sao._picture_maps(plan, geom, device)
        srcs = [torch.from_numpy(x).to(device) for x in p["post"]]
        args = sao.sao_picture_args(plan, maps, srcs)
        plain = [sao.sao_plane_args(plan, maps, c, s)
                 for c, s in enumerate(srcs)]
        cold = cold_inputs(srcs)
        h, w = srcs[0].shape
        return (lambda: sao.sao_picture_frames([s[None] for s in cold()],
                                               *args[1:]),
                lambda: [sao.sao_frames(*sao.sao_ctb_args(plan, maps, c, s))
                         for c, s in enumerate(cold())],
                lambda: [sao._sao_plane(s, *a[1:])
                         for s, a in zip(cold(), plain)],
                sao_bound(args), f"{w}x{h}")

    big = picture(pic)
    with open(STREAM, "rb") as fh:
        small = picture(next(p for p in capture_pictures(fh.read())
                             if p["sao"] is not None))
    plane = lfc.tensors(lfc.sao_synthetic(np.random.default_rng(5), 1080,
                                          1920, 8, 64), device)
    pcold = cold_inputs(plane[0])
    row = dict(max_abs_err=err, kname="sao",
               ms=timed_ms(big[0], device, reps),
               plain_ms=timed_ms(big[2], device, max(1, reps // 4)),
               bound_ms=big[3][0], bound_by=big[3][1], timed={})
    for name, p in (("the 1080p SAO-coded encode's", big),
                    ("a vfy_sweep", small)):
        row["timed"][f"sao at {name} {p[4]} picture, 3 components in one "
                     f"launch"] = (p[0], p[3][0])
        row["timed"][f"sao at {name} {p[4]} picture, one launch per "
                     f"component"] = (p[1], p[3][0])
    row["timed"]["sao at a synthetic 1920x1080 luma plane"] = (
        lambda: sao.sao_frames(pcold(), *plane[1:]), sao_bound(plane)[0])
    log(f"sao at its row's shape (a {big[4]} picture, 3 components): "
        f"kernel {row['ms']:.4f} ms, plain torch {row['plain_ms']:.4f} ms "
        f"(median, CUDA events around the wrapper); bound "
        f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return row


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
    """A function returning, call after call, one of enough copies of x (a
    tensor, or a list of tensors copied together)
    that together they overflow the card's 50 MB L2 cache four times: a
    kernel timed on it reads its input from device memory, as one whose
    input was not just written would (a 16.6 MB batch read again at once
    would come from L2, faster than the bound counts)."""
    many = isinstance(x, (list, tuple))
    nbytes = sum(t.nbytes for t in x) if many else x.nbytes
    copies = [x] + [[t.clone() for t in x] if many else x.clone()
                    for _ in range(max(1, -(-4 * l2_bytes // nbytes)) - 1)]
    turn = [0]

    def next_copy():
        turn[0] += 1
        return copies[turn[0] % len(copies)]
    return next_copy


def check_dsp_ops(device, reps):
    """The DSP op library at one 1080p picture's block counts: the forward
    transform and all-phase interpolation kernels against their plain
    versions on the card (8 and 10 bits, and 14 for the interpolation,
    random and extreme inputs, every size, the DST, every phase), the torch
    ops (metrics, quantization, all-modes intra) on the card against the
    same code on the CPU; times and bounds of the two kernels, on inputs
    read from device memory. Returns their kernels-line rows."""
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
    # one 1080p picture's blocks of each shape (the first three timed, the
    # first the row's); 8x4 and 4x8 put 4-8 windows in a warp, 64x64 takes
    # the kernel's row bands; then a width that splits warps across windows
    # and a batch that leaves the last tile part-filled
    for (w, h, b) in ((16, 16, 8160), (8, 8, 32400), (64, 64, 510),
                      (8, 4, 64800), (4, 8, 64800), (32, 32, 2040),
                      (12, 20, 1001)):
        for bd in (8, 10, 14):
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
            if bd == 8 and (w, h) in ((16, 16), (8, 8), (64, 64)):
                cold = cold_inputs(x)
                ip_timed[f"interp_all_phases {w}x{h} at B={b}"] = (
                    lambda cold=cold, w=w, h=h: inter.interp_luma_all_phases(
                        cold(), w, h), interp_bound(b, w, h)[0])
                if w == 16:
                    ip_row = (cold, b, w, h)
        log(f"kernel vs plain, interp_all_phases {w}x{h} at B={b}, 8, 10 "
            f"and 14 bits, random and extreme windows, all 16 phases: equal")

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
    cold, b, w, h = ip_row
    bnd = interp_bound(b, w, h)
    rows["interp_all_phases"] = dict(
        max_abs_err=max(ip_errs), kname="interp_all_phases",
        ms=timed_ms(lambda: inter.interp_luma_all_phases(cold(), w, h),
                    device, reps),
        plain_ms=timed_ms(
            lambda: inter.interp_luma_all_phases_ref(cold(), w, h), device,
            max(1, reps // 4)),
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
        r["device_us_by_shape"] = {}
        for i, (what, (fn, bound_ms)) in enumerate(r.pop("timed").items()):
            us, per = device_us(fn, r["kname"])
            r["device_us_by_shape"][what] = us
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
    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.ops import deblock, dense_me, inter, sao
    from turingcodec_tpu_torch.ops import transform
    dense_me.launches = inter.launches = transform.launches = 0
    inter.interp_launches = transform.fwd_launches = 0
    da.rank_launches = da.subpel_launches = 0
    deblock.launches = sao.launches = 0


def read_launches():
    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.ops import deblock, dense_me, inter, sao
    from turingcodec_tpu_torch.ops import transform
    return {"dense_me": dense_me.launches, "mc_block_grid": inter.launches,
            "dequant_idct": transform.launches,
            "fwd_transform": transform.fwd_launches,
            "interp_all_phases": inter.interp_launches,
            "rank_satd": da.rank_launches,
            "subpel_planes": da.subpel_launches,
            "deblock": deblock.launches, "sao": sao.launches}


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

    from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures
    stream_launches = {}
    for name in ("vfy_sweep.hevc", "static_test.hevc"):
        data = open(os.path.join(ROOT, "tests", "streams", name), "rb").read()
        n_sao = sum(1 for p in capture_pictures(data) if p["sao"] is not None)
        dp.pictures = dp.envelope_host = 0
        reset_launches()
        got, dec, _ = decode_planes(data, dev)
        stream_launches[name] = read_launches()
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
        # one deblocking launch per picture; one SAO launch (all three
        # components) per picture that codes SAO: vfy_sweep's 9
        sl = stream_launches[name]
        check(sl["deblock"] == dp.pictures and sl["sao"] == n_sao
              and (n_sao == 9 or name != "vfy_sweep.hevc"),
              f"{name}: launches {sl} for {dp.pictures} pictures, {n_sao} "
              f"of them SAO-coded")
        log(f"decode {name} with device={dev}: {len(got)} frames, md5 "
            f"{want} OK, all through the pipeline; deblock launches "
            f"{sl['deblock']}, sao launches {sl['sao']} ({n_sao} SAO-coded "
            f"pictures)")

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
    # one deblocking launch per picture (both directions); no SAO in this
    # stream
    check(0 < launches["mc_block_grid"] <= 3 * (n - 1)
          and 0 < coded <= n - 1 and launches["dequant_idct"] == coded
          and launches["deblock"] == n
          and launches["dense_me"] == launches["fwd_transform"]
          == launches["interp_all_phases"] == launches["rank_satd"]
          == launches["subpel_planes"] == launches["sao"] == 0,
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
    stage_split(dev, bitstream, n)
    return launches, stream_launches["vfy_sweep.hevc"], residual_stage(
        dev, bitstream)


def deep_decode(device):
    """The 13-bit stream of tools/deep_bits.py decoded on the card (kernel
    counts read around this run) to the JAX pipeline's md5, every picture
    through the pipeline, MC and the residuals each launched on its inter
    pictures, one deblocking launch per picture; then its 14- and 16-bit
    streams raise the reference's error. Returns the 13-bit decode's
    launches."""
    from turingcodec_tpu_torch.tools import deep_bits
    reset_launches()   # the stream is encoded on the host path
    deep_bits.check_13(str(device), log)
    launches = read_launches()
    check(launches["mc_block_grid"] and launches["dequant_idct"]
          and launches["deblock"] == 3,
          f"13-bit decode of 3 pictures launched {launches}")
    log(f"13-bit decode on the card: launches {launches}")
    deep_bits.check_raises(str(device), log)
    return launches


def sao_stream(device, frames):
    """The main path's 1080p input, its first 3 frames, encoded with SAO on
    (the encoder's default; the main path turns it off) on the card and on
    the host (identical bytes); decoded on the card (kernel counts read
    around this run) equal to the host decode, hash-clean, every picture
    through the pipeline with one SAO launch per SAO-coded picture; then
    one more card decode traced for each stage's ms per picture. Returns
    (the decode's launches, the captured pictures)."""
    import numpy as np

    from turingcodec_tpu_torch.decode import device_pipeline as dp
    from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures
    from turingcodec_tpu_torch.tools.device_enc_check import encode
    dev = str(device)
    clip = frames[:3]
    t0 = time.perf_counter()
    bs, fps = encode(clip, dev, QP, sao=True)
    bs_host, fps_host = encode(clip, None, QP, sao=True)
    check(bs == bs_host, "SAO encode: card and host bitstreams differ")
    pics = capture_pictures(bs)
    n_sao = sum(1 for p in pics if p["sao"] is not None)
    check(len(pics) == len(clip) and n_sao > 0,
          f"SAO encode: {len(pics)} pictures, {n_sao} SAO-coded")
    dp.pictures = dp.envelope_host = 0
    reset_launches()
    got, dec, t_dev = decode_planes(bs, dev)
    launches = read_launches()
    pictures, envelope = dp.pictures, dp.envelope_host
    want, dec_h, t_host = decode_planes(bs, None)
    check(len(got) == len(clip) and dec.hash_failures == 0
          and dec_h.hash_failures == 0, "SAO decode: frames or hashes")
    check(all(np.array_equal(a, b) for fa, fb in zip(got, want)
              for a, b in zip(fa, fb)),
          "SAO decode on the card differs from the host decode")
    check(pictures == len(clip) and envelope == 0
          and launches["sao"] == n_sao
          and launches["deblock"] == len(clip),
          f"SAO decode: {pictures} pictures through the pipeline, "
          f"{envelope} on the host, launches {launches} for {n_sao} "
          f"SAO-coded pictures")
    h, w = clip[0][0].shape
    log(f"SAO-coded encode, {len(clip)} frames {w}x{h}: {len(bs)} bytes "
        f"identical on the card ({fps:.4f} fps) and the host "
        f"({fps_host:.4f} fps), {n_sao} SAO-coded pictures; decoded on the "
        f"card equal to the host, 0 hash failures, all through the "
        f"pipeline; launches {launches} ({time.perf_counter() - t0:.1f} s)")
    split = stage_split(dev, bs, len(clip))
    log(f"SAO-coded 1080p decode: sao stage {split['sao']:.3f} ms per "
        f"picture (host clock, the card synchronised at each probe)")
    return launches, pics


def stage_split(dev, bitstream, n):
    """One more card decode with TURING_TPU_PIPELINE_TRACE set (the card
    synchronised at each stage's end): each stage's host-clock ms per
    picture, and the rest of the decode (parse, dispatch, the host's
    picture handling)."""
    from turingcodec_tpu_torch.decode import device_pipeline as dp
    dp.stage_seconds.clear()
    os.environ["TURING_TPU_PIPELINE_TRACE"] = "1"
    try:
        t = decode_planes(bitstream, dev)[2]
    finally:
        os.environ.pop("TURING_TPU_PIPELINE_TRACE", None)
    split = {k: v / n * 1e3 for k, v in dp.stage_seconds.items()}
    log(f"card decode stages, ms per picture (host clock, the card "
        f"synchronised at each probe, {n} pictures): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; the rest {(t / n * 1e3) - sum(split.values()):.3f}; "
        f"total {t / n * 1e3:.3f}")
    return split


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


def driven(path: dict, fn):
    """fn() with every launch count set to 0 just before it and read just
    after, added to `path`; returns fn's result."""
    reset_launches()
    out = fn()
    for k, v in read_launches().items():
        path[k] = path.get(k, 0) + v
    return out


def signature_phase(device):
    """The encoder's configuration matrix (tools/signature.py) with the
    analysis stage and the decode on the card, against the goldens pinned
    from the JAX package; its 10-bit row is dense_me's first 10-bit run
    inside an encode. Returns the path's launches."""
    from turingcodec_tpu_torch.tools import signature
    t0 = time.perf_counter()
    path = {}
    fails = driven(path, lambda: signature.run(device=str(device), log=log))
    check(fails == 0, f"signature matrix on the card: {fails} failures")
    check(path["dense_me"] and path["mc_block_grid"]
          and path["dequant_idct"], f"signature launches {path}")
    log(f"signature matrix, {len(signature.CONFIGS)} rows on the card: "
        f"every golden and recon == decode ({time.perf_counter() - t0:.1f} "
        f"s); launches {path}")
    return path


def tool_matrix_phase(device, frames):
    """The encoder's tool configurations (tools/tool_matrix.py: AQ,
    rate control, shot change, tiles, slices, transform skip) on the card.
    Each row is encoded with the analysis stage on the card (kernel counts
    read around it) and on the host: identical bytes, the JAX package's
    pinned golden, the row's tool reached, dense_me and subpel_planes
    launched, rank_satd launched except under tiles or slices (the
    encoder's gate). Then decoded on the card (kernel counts read around
    it) equal to the host decode and the golden, hash-clean, every picture
    through the pipeline, one deblocking launch per picture and one SAO
    launch per SAO-coded picture; the 1080p rows' decode stage split.
    Returns the path's launches."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch.decode import device_pipeline as dp
    from turingcodec_tpu_torch.parallel.gop_decode import capture_pictures
    from turingcodec_tpu_torch.tools import tool_matrix as tm
    dev = str(device)
    t_all = time.perf_counter()
    path = {}
    for row in tm.ROWS:
        name, t0 = row.name, time.perf_counter()
        inp = tm.row_input(name, frames if row.source == "main" else None)
        n = len(inp)
        h, w = inp[0][0].shape
        enc = {}
        bs, plans, dt = driven(enc, lambda: tm.encode_row(name, inp, dev))
        bs_host, _, dt_host = tm.encode_row(name, inp, None)
        check(bs == bs_host, f"{name}: card and host bitstreams differ")
        what = tm.reach(name, bs, plans)
        tiled = row.overrides.get("slices", 1) > 1 \
            or row.overrides.get("tile_cols", 1) > 1
        check(enc["dense_me"] and enc["subpel_planes"]
              and (enc["rank_satd"] == 0) == tiled,
              f"{name}: encode launches {enc}")
        n_sao = sum(p["sao"] is not None for p in capture_pictures(bs))
        dp.pictures = dp.envelope_host = 0
        dec = {}
        got, d = driven(dec, lambda: tm.decode(bs, dev))
        torch.cuda.synchronize()
        pictures, envelope = dp.pictures, dp.envelope_host
        want, d_host = tm.decode(bs, None)
        check(len(got) == len(want) == n and d.hash_failures == 0
              and d_host.hash_failures == 0 and not d.violations,
              f"{name}: {len(got)} frames decoded on the card, "
              f"{d.hash_failures} hash failures")
        check(all(np.array_equal(a, b) for fa, fb in zip(got, want)
                  for a, b in zip(fa, fb)),
              f"{name}: the card decode differs from the host decode")
        check(tm.hashes(bs, got) == tm.hashes(bs, want) == row.golden,
              f"{name}: {tm.hashes(bs, got)} against the golden "
              f"{row.golden}")
        check(pictures == n and envelope == 0,
              f"{name}: {pictures} pictures through the pipeline, "
              f"{envelope} on the host")
        check(dec["deblock"] == n and dec["sao"] == n_sao
              and dec["mc_block_grid"],
              f"{name}: decode launches {dec} for {n} pictures, {n_sao} "
              f"SAO-coded")
        log(f"tool row {name}, {n} frames {w}x{h}: {len(bs)} bytes "
            f"identical on the card ({n / dt:.4f} fps) and the host "
            f"({n / dt_host:.4f} fps), golden {row.golden} OK; {what}; "
            f"encode launches dense_me {enc['dense_me']}, subpel_planes "
            f"{enc['subpel_planes']}, rank_satd {enc['rank_satd']}; "
            f"decoded on the card equal to the host, 0 hash failures, "
            f"{pictures} pictures through the pipeline, {n_sao} SAO-coded; "
            f"decode launches {dec} ({time.perf_counter() - t0:.1f} s)")
        if (w, h) == (1920, 1080):
            stage_split(dev, bs, n)
        for k in set(enc) | set(dec):
            path[k] = path.get(k, 0) + enc.get(k, 0) + dec.get(k, 0)
    log(f"tool matrix, {len(tm.ROWS)} rows on the card: "
        f"{time.perf_counter() - t_all:.1f} s; launches {path}")
    return path


def bitflip_phase(device):
    """Bit flips of vfy_sweep (tools/bitflip.py's positions) decoded
    through the card pipeline (kernel counts read around each decode): no
    CUDA error after any of them, and each ends as the host decode does,
    with the same Violation clause or the same planes, hash failures and
    recorded violations. Returns the path's launches."""
    import torch

    from turingcodec_tpu_torch.tools import bitflip
    dev = str(device)
    t0 = time.perf_counter()
    data = open(STREAM, "rb").read()
    cases = [(p, 0x01) for p in bitflip.POSITIONS["header"]] + [
        (p, bit) for p in bitflip.POSITIONS["slice"] for bit in bitflip.BITS]
    path, kinds = {}, {}
    for pos, bit in cases:
        mut = bitflip.flipped(data, pos, bit)
        got = driven(path, lambda: bitflip.outcome(mut, dev))
        torch.cuda.synchronize()   # raises on a sticky CUDA error
        want = bitflip.outcome(mut, None)
        check(bitflip.same(got, want),
              f"flip of bit {bit:#x} at byte {pos}: the card decode ends "
              f"{got[0]} {got[1] if got[0] == 'violation' else ''}, the "
              f"host decode {want[0]} "
              f"{want[1] if want[0] == 'violation' else ''}")
        check(got[0] == "decoded" or bitflip.tagged(got[1]),
              f"flip at byte {pos}: untagged violation {got[2]}")
        kinds[got[0]] = kinds.get(got[0], 0) + 1
    check(path["deblock"], f"bit flips launched no deblock: {path}")
    log(f"bit flips of vfy_sweep on the card: {len(cases)} cases, no CUDA "
        f"error, each ending as the host decode ({kinds}; "
        f"{time.perf_counter() - t0:.1f} s); launches {path}")
    return path


def gop_blocks(plane):
    """A 1920x1080 plane as its 2040 32x32 blocks (the bottom row of
    blocks edge-replicated to 1088)."""
    import numpy as np
    p = np.pad(plane, ((0, (-plane.shape[0]) % 32), (0, 0)), "edge")
    hh, ww = p.shape
    return p.reshape(hh // 32, 32, ww // 32, 32).transpose(0, 2, 1, 3) \
        .reshape(-1, 32, 32)


def coded_tus(plan, log2: int):
    """Every coded luma TU of size 2^log2 of a picture: (levels (N, n, n)
    int32, QPs (N,) int32)."""
    import numpy as np
    n, step = 1 << log2, (1 << log2) // 4
    tu, cbf = np.asarray(plan.tu_log2), np.asarray(plan.cbf_y)
    ys, xs = np.nonzero(((tu == log2) & (cbf != 0))[::step, ::step])
    coeff, qp = np.asarray(plan.coeff_y), np.asarray(plan.qp_y)
    lv = [coeff[n * y:n * y + n, n * x:n * x + n] for y, x in zip(ys, xs)]
    return (np.asarray(lv, np.int32).reshape(-1, n, n),
            qp[ys * step, xs * step].astype(np.int32))


def gop_stages(device, frames, bitstream, reps):
    """The GOP-batched stages at 1080p on the 8-frame upscaled encode,
    each against per-frame calls on the card and against its plain
    version or host twin: analysis_step over 8 x 2040 32x32 blocks, MC of
    the 7 inter pictures in one launch, the residuals of every coded luma
    TU (one launch per size), deblocking of the 8 pictures, SAO of
    vfy_sweep's SAO pictures, and analysis_frames_batched over 7 pairs.
    Returns (the path's launches, profile jobs for phase 10)."""
    import numpy as np
    import torch

    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.encode import device_analysis as da
    from turingcodec_tpu_torch.ops.deblock import deblock_device
    from turingcodec_tpu_torch.ops.inter import (mc_block_grid,
                                                 mc_block_grid_ref)
    from turingcodec_tpu_torch.ops.sao import _sao_plane
    from turingcodec_tpu_torch.ops.transform import dequant_inverse_transform
    from turingcodec_tpu_torch.parallel import gop_decode as gd
    from turingcodec_tpu_torch.parallel.mesh import analysis_step
    from turingcodec_tpu_torch.tools.scaling import (gather_workloads,
                                                     stack_workloads)
    t_all = time.perf_counter()
    path, jobs = {}, []
    f = len(frames)

    def timing(what, batched, per_frame, n):
        ms_b = timed_ms(batched, device, reps)
        ms_p = timed_ms(per_frame, device, reps)
        log(f"{what}: batched {ms_b:.4f} ms, {n} per-frame calls "
            f"{ms_p:.4f} ms (median, CUDA events)")
        jobs.append((what, batched, per_frame, n))

    # the encoder analysis step over 8 x 2040 blocks
    t0 = time.perf_counter()
    ctus = np.stack([gop_blocks(fr[0]) for fr in frames])[:, None]
    preds = np.stack([gop_blocks(frames[max(i - 1, 0)][0])
                      for i in range(f)])[:, None]
    c_h, p_h = (torch.from_numpy(a.astype(np.int32)) for a in (ctus, preds))
    c_d, p_d = c_h.to(device), p_h.to(device)
    got = driven(path, lambda: analysis_step(c_d, p_d, QP))
    plain = analysis_step(c_h, p_h, QP)
    for i in range(f):
        one = analysis_step(c_d[i:i + 1], p_d[i:i + 1], QP)
        check(all(torch.equal(g[i:i + 1], o) for g, o in zip(got[:2], one)),
              "analysis_step differs from its per-frame call")
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, plain)),
          "analysis_step differs from its plain version")
    log(f"analysis_step over {tuple(ctus.shape[:3])} 32x32 blocks: equal to "
        f"the per-frame calls and the plain version (CPU); rate total "
        f"{int(got[2])}, distortion total {int(got[3])} "
        f"({time.perf_counter() - t0:.1f} s)")
    timing(f"analysis_step, {f} x {ctus.shape[2]} blocks",
           lambda: analysis_step(c_d, p_d, QP),
           lambda: [analysis_step(c_d[i:i + 1], p_d[i:i + 1], QP)
                    for i in range(f)], f)

    # MC of the inter pictures, one launch
    t0 = time.perf_counter()
    works = gather_workloads(bitstream, f - 1)
    check(len(works) == f - 1, f"{len(works)} inter pictures")
    refs, cols, nb = stack_workloads(works)
    r_d = torch.from_numpy(refs).to(device)
    a_d = [torch.from_numpy(cols[k]).to(device)
           for k in ("sel", "xi", "yi", "xf", "yf")]
    before = path.get("mc_block_grid", 0)
    got = driven(path, lambda: gd.gop_mc(r_d, *a_d))
    check(path["mc_block_grid"] - before == 1, "GOP MC took more launches")
    per_pic = []
    for i, wk in enumerate(works):
        a = [torch.from_numpy(np.asarray(wk[k], np.int32)[None]).to(device)
             for k in ("sel", "xi", "yi", "xf", "yf")]
        planes = [[torch.from_numpy(wk["refs"]).to(device)]]
        per_pic.append((planes, a))
        want = mc_block_grid(planes, *a, 4, 8, 8)[0, 0]
        check(torch.equal(got[i, :nb[i]], want)
              and torch.equal(want, mc_block_grid_ref(planes, *a, 4, 8,
                                                      8)[0, 0]),
              "GOP MC differs from the per-picture call or the plain one")
    log(f"GOP MC, {len(works)} inter pictures x {cols['sel'].shape[1]} "
        f"blocks ({sum(nb)} real) in one mc_block_grid launch: equal to "
        f"the per-picture calls and their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    timing(f"GOP MC, {len(works)} pictures", lambda: gd.gop_mc(r_d, *a_d),
           lambda: [mc_block_grid(pl, *a, 4, 8, 8) for pl, a in per_pic],
           len(works))

    # residuals of every coded luma TU, one launch per size
    t0 = time.perf_counter()
    pics = gd.capture_pictures(bitstream)
    check(len(pics) == f, f"{len(pics)} pictures captured")
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        tus = [coded_tus(p["plan"], log2) for p in pics]
        m = max(len(q) for _, q in tus)
        if m == 0:
            continue
        blocks = np.zeros((f, m, n, n), np.int32)
        qps = np.full((f, m), 30, np.int32)
        blocks[:, :, 0, 0] = 64         # padding: a DC block at QP 30
        for i, (lv, q) in enumerate(tus):
            blocks[i, :len(q)], qps[i, :len(q)] = lv, q
        b_d, q_d = (torch.from_numpy(a).to(device) for a in (blocks, qps))
        got = driven(path, lambda: gd.gop_residual(b_d, q_d, 8, log2))
        for i in range(f):
            check(torch.equal(got[i:i + 1], gd.gop_residual(
                b_d[i:i + 1], q_d[i:i + 1], 8, log2))
                and torch.equal(got[i].cpu(), dequant_inverse_transform(
                    torch.from_numpy(blocks[i]), torch.from_numpy(qps[i]), 8,
                    log2, 0)),
                f"GOP residual {n}x{n} differs from the per-frame call or "
                f"the plain version")
        log(f"GOP residual {n}x{n}: {f} pictures x {m} coded TUs "
            f"({sum(len(q) for _, q in tus)} real) in one dequant_idct "
            f"launch: equal to the per-frame calls and the plain version")
        if log2 == 3:
            timing(f"GOP residual 8x8, {f} x {m} TUs",
                   lambda b_d=b_d, q_d=q_d: gd.gop_residual(b_d, q_d, 8, 3),
                   lambda b_d=b_d, q_d=q_d: [gd.gop_residual(
                       b_d[i:i + 1], q_d[i:i + 1], 8, 3) for i in range(f)],
                   f)
    log(f"GOP residuals: {time.perf_counter() - t0:.1f} s")

    # deblocking of the 8 pictures in the kernel's one launch
    t0 = time.perf_counter()
    args, geo = gd.deblock_inputs(pics, device)
    before = path.get("deblock", 0)
    got = driven(path, lambda: gd.gop_deblock(*args, *geo))
    check(path["deblock"] - before == 1, "GOP deblock took more launches")
    per = [((args[0][i], args[1][i], args[2][i], tuple(m[i] for m in args[3]),
             tuple(v[i] for v in args[4]), *geo, bool(args[5][i])))
           for i in range(f)]
    for i, a in enumerate(per):
        one = deblock_device(*a)
        check(all(torch.equal(o, g[i]) for o, g in zip(one, got))
              and all(np.array_equal(g[i].cpu().numpy(), pics[i]["post"][k])
                      for k, g in enumerate(got)),
              "GOP deblocking differs from the per-frame call or the host")
    h, w = frames[0][0].shape
    log(f"GOP deblock, {f} pictures {w}x{h} in one deblock launch: equal "
        f"to the per-frame calls and the host decoder's planes "
        f"({time.perf_counter() - t0:.1f} s)")
    timing(f"GOP deblock, {f} pictures", lambda: gd.gop_deblock(*args, *geo),
           lambda per=per: [deblock_device(*a) for a in per], f)

    # SAO of vfy_sweep's SAO pictures, each component
    t0 = time.perf_counter()
    with open(STREAM, "rb") as fh:
        sao_pics = [p for p in gd.capture_pictures(fh.read())
                    if p["sao"] is not None]
    check(sao_pics, "vfy_sweep has no SAO picture")
    for c_idx in range(3):
        stacked, (ctb, bd, sub), per = gd.sao_inputs(sao_pics, c_idx, device)
        before = path.get("sao", 0)
        got = driven(path, lambda: gd.gop_sao(*stacked, ctb=ctb, bd=bd,
                                              sub=sub))
        check(path["sao"] - before == 1, "GOP SAO took more launches")
        for i, a in enumerate(per):
            check(torch.equal(_sao_plane(*a), got[i])
                  and torch.equal(gd.gop_sao(*(x[i:i + 1] for x in stacked),
                                             ctb=ctb, bd=bd, sub=sub)[0],
                                  got[i])
                  and np.array_equal(got[i].cpu().numpy(),
                                     sao_pics[i]["sao"][c_idx]),
                  "GOP SAO differs from the plain or the per-frame call or "
                  "the host")
        if c_idx == 0:
            timing(f"GOP SAO luma, {len(per)} pictures 640x360",
                   lambda st=stacked, c=(ctb, bd, sub): gd.gop_sao(
                       *st, ctb=c[0], bd=c[1], sub=c[2]),
                   lambda st=stacked, c=(ctb, bd, sub), n=len(per): [
                       gd.gop_sao(*(x[i:i + 1] for x in st), ctb=c[0],
                                  bd=c[1], sub=c[2]) for i in range(n)],
                   len(per))
    log(f"GOP SAO, {len(sao_pics)} vfy_sweep pictures, 3 components, one "
        f"sao launch each: equal to the plain version, the per-frame calls "
        f"and the host decoder's planes ({time.perf_counter() - t0:.1f} s)")

    # the batched seed and dense analysis over 7 (orig, ref) pairs
    t0 = time.perf_counter()
    origs = np.stack([fr[0] for fr in frames[1:]])
    refs_a = np.stack([fr[0] for fr in frames[:-1]])
    before = path.get("dense_me", 0)
    got = driven(path, lambda: da.analysis_frames_batched(origs, refs_a,
                                                          device, 8))
    check(path["dense_me"] - before == len(origs),
          "analysis_frames_batched: not one sweep per pair")
    for i in range(len(origs)):
        one = da.analysis_device(origs[i], refs_a[i], device, bit_depth=8)
        nat = native.dense_analysis(origs[i], refs_a[i], 8)
        check(all(np.array_equal(g[i], o) and np.array_equal(g[i], n_)
                  for g, o, n_ in zip(got[:3], one[:3], nat[:3])),
              "analysis_frames_batched differs from the per-pair call or "
              "the native host twin")
    log(f"analysis_frames_batched over {len(origs)} {w}x{h} pairs "
        f"({len(origs)} dense_me launches): equal to the per-pair calls and "
        f"the native host twin ({time.perf_counter() - t0:.1f} s)")
    timing(f"analysis_frames_batched, {len(origs)} pairs",
           lambda: da.analysis_frames_batched(origs, refs_a, device, 8),
           lambda: [da.analysis_device(origs[i], refs_a[i], device,
                                       bit_depth=8)
                    for i in range(len(origs))], len(origs))
    for k in ("dense_me", "mc_block_grid", "dequant_idct", "fwd_transform",
              "deblock", "sao"):
        check(path.get(k), f"GOP stages launched no {k}: {path}")
    log(f"GOP stages: {time.perf_counter() - t_all:.1f} s; launches {path}")
    return path, jobs


def tools_phase(device):
    """tools/scaling.py and entry.py on the card, and bdrate's run_ours on
    vfy_sweep at its four QPs on the card and the host (identical bytes).
    Returns the path's launches."""
    from turingcodec_tpu_torch import entry
    from turingcodec_tpu_torch.tools import bdrate, scaling
    t0 = time.perf_counter()
    path = {}
    check(driven(path, lambda: scaling.main(["--frames", "8"])) == 0,
          "tools/scaling.py: batched MC differs from the per-picture calls")
    clip = bdrate.decode_clip()
    for qp in bdrate.QPS:
        card, recs, dt = driven(path, lambda: bdrate.encode_ours(
            clip, qp, "fast", 1, str(device)))
        host = bdrate.encode_ours(clip, qp, "fast", 1, None)[0]
        check(card == host, f"bdrate run_ours at QP {qp}: card and host "
                            f"bytes differ")
        psnr = sum(bdrate.psnr_y(recs[i][0], clip[i][0])
                   for i in range(len(clip))) / len(clip)
        log(f"bdrate run_ours vfy_sweep fast-LDP QP {qp}: {len(card)} bytes "
            f"identical on the card and the host, PSNR-Y {psnr:.3f} dB, "
            f"{len(clip) / dt:.2f} fps on the card")
    step, args = entry.entry(str(device))
    levels, rate, satd = driven(path, lambda: step(*args))
    check(levels.shape == (8, 32, 32) and rate.shape == satd.shape == (8,),
          "entry step shapes")
    driven(path, lambda: entry.dryrun(4, 2, str(device), log))
    for k in ("dense_me", "mc_block_grid", "dequant_idct", "fwd_transform"):
        check(path.get(k), f"tools launched no {k}: {path}")
    log(f"tools scaling, bdrate and entry on the card: "
        f"{time.perf_counter() - t0:.1f} s; launches {path}")
    return path


def profile_counts(jobs, n: int = 3):
    """Each batched stage against its F per-frame calls: CUDA kernels
    launched per call and their device time (torch.profiler over n calls
    after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def count(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = kernels = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0)
            if t > 0 and not e.key.startswith(("Memcpy", "Memset")):
                us += t
                kernels += e.count
        return kernels / n, us / n

    for what, batched, per_frame, f in jobs:
        kb, ub = count(batched)
        kp, up = count(per_frame)
        log(f"{what}: batched {kb:.0f} kernels, {ub:.2f} us device time per "
            f"call; {f} per-frame calls {kp:.0f} kernels, {up:.2f} us "
            f"(profiler)")


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
    occupancy()

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
    # the stage's rank-SATD and subpel kernels against their plain versions
    ana_kern = check_analysis_kernels(device, frames, geom.zscan, reps=20)

    # 5. main path: the encode
    enc_launches, bitstream = main_path(frames, device)

    # 6. decode stages against their host twins (1080p encode, vfy_sweep)
    captured = check_decode_stages(device, [
        ("the 1080p encode", bitstream),
        ("vfy_sweep", open(STREAM, "rb").read())])

    # 7. decoder kernels against their plain versions on the card: MC and
    # residuals, then deblocking and SAO
    dec_kern = check_decode_kernels(device, captured, reps=20)
    dec_kern["deblock"], sao_err = check_loop_filters(device, bitstream,
                                                      reps=20)

    # 8. main path: the decode on the card; then the stage split and the
    # residual stage timed; a 1080p SAO-coded encode decoded on the card
    dec_launches, vfy_launches, res_pics = decode_main_path(
        device, frames, bitstream)
    sao_launches, sao_pics = sao_stream(device, frames)
    dec_kern["sao"] = sao_row(device, sao_pics[1], sao_err, reps=20)
    # the decode of a 13-bit stream, and the 14- and 16-bit ones that raise
    deep_launches = deep_decode(device)

    # 9. the DSP op library at full width: its two kernels against their
    # plain versions, the torch ops against the CPU; then its own path,
    # tools/kernels.py, and tools/testdecode.py on the card
    dsp_kern = check_dsp_ops(device, reps=20)
    dsp_launches = dsp_path(device)

    # 10. the configuration matrix on the card (tools/signature.py)
    sig_launches = signature_phase(device)
    # 10b. the encoder's tool configurations on the card against the JAX
    # package's goldens (tools/tool_matrix.py); bit flips of vfy_sweep
    # through the card pipeline against the host decode
    tm_launches = tool_matrix_phase(device, frames)
    flip_launches = bitflip_phase(device)

    # 11. the GOP-batched stages at 1080p against per-frame calls and their
    # plain versions; then the tools over them and the entry points
    gop_launches, gop_jobs = gop_stages(device, frames, bitstream, reps=5)
    tool_launches = tools_phase(device)

    # 12. device time per launch of each kernel at the main path's shapes;
    # kernels and device time of each batched stage against its per-frame
    # calls
    rows = [dict(name="dense_me_argmin", source="dense_me.cu",
                 replaces="turingcodec_tpu/ops/pallas_kernels.py:71",
                 launches=enc_launches["dense_me"], **kern),
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
                 **dsp_kern["interp_all_phases"]),
            dict(name="rank_satd_tables", source="rank_satd.cu",
                 replaces="turingcodec_tpu/encode/device_analysis.py:628",
                 launches=enc_launches["rank_satd"],
                 **ana_kern["rank_satd"]),
            dict(name="subpel_planes", source="subpel_planes.cu",
                 replaces="turingcodec_tpu/encode/device_analysis.py:338",
                 launches=enc_launches["subpel_planes"],
                 **ana_kern["subpel_planes"]),
            dict(name="deblock", source="deblock.cu",
                 replaces="turingcodec_tpu/ops/deblock.py:272",
                 launches=dec_launches["deblock"], **dec_kern["deblock"]),
            dict(name="sao", source="sao.cu",
                 replaces="turingcodec_tpu/ops/sao.py:33",
                 launches=vfy_launches["sao"], **dec_kern["sao"])]
    device_times(rows)
    profile_counts(gop_jobs)
    kern_us, copy_us, per = residual_device_us(res_pics)
    log(f"residual stage on the card per inter picture of the 1080p decode "
        f"({len(res_pics)} pictures): {kern_us:.2f} us of kernels in {per} "
        f"launches, {copy_us:.2f} us of copies (profiler)")

    log(card)
    # no single PyTorch call computes any of the nine functions (a
    # penalised argmin over 289 SADs, a per-block filter phase, an integer
    # dequantisation before two products, two integer products with a
    # rounding shift between them, 16 filter phases with their shifts and
    # exact-phase cases, 35 intra predictions with substituted and filtered
    # references and a Hadamard SATD each, 15 clamped filter phases, edge
    # decisions and filters driven by per-block maps, per-CTB band and
    # edge offsets with neighbour rules), so library_ms is null
    log(json.dumps({"kernels": [{
        "name": r["name"], "route": "cuda",
        "source": "turingcodec_tpu_torch/csrc/" + r["source"],
        "replaces": r["replaces"], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_us": r["device_us"], "bound_us": r["bound_ms"] * 1e3,
        "share": r["bound_ms"] * 1e3 / r["device_us"],
        "device_us_by_shape": r["device_us_by_shape"],
        "launches_by_path": {
            "encode": enc_launches[r["kname"]],
            "decode": dec_launches[r["kname"]],
            "vfy_sweep_decode": vfy_launches[r["kname"]],
            "sao_1080p_decode": sao_launches[r["kname"]],
            "decode_13_bit": deep_launches[r["kname"]],
            "dsp_tools": dsp_launches[r["kname"]],
            "signature": sig_launches[r["kname"]],
            "tool_matrix": tm_launches[r["kname"]],
            "bitflip_decodes": flip_launches[r["kname"]],
            "gop_stages": gop_launches[r["kname"]],
            "scaling_bdrate_entry": tool_launches[r["kname"]]}}
        for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
