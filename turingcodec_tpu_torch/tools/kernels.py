"""CLI: DSP op self-test + throughput benchmark on a torch device (the
`turing havoc` analogue, havoc/havoc.cpp:161-211): every op family is
checked bit-exact against its numpy oracle, then timed; the native SATD
kernels are checked against their C template.

Usage: python -m turingcodec_tpu_torch.tools.kernels [--batch N]
           [--iters N] [--device {cuda,cpu}]

--device cuda (the default) runs the ops on the GPU, the forward transform,
the all-phase interpolation and the decoder's residual stage (dequantization,
inverse DCT, add and clip of a batch of TUs: the `dequant_idct_NxN` rows,
where the JAX tool times the inverse DCT and the dequantization apart)
through their CUDA kernels, and raises without a GPU; cpu runs the same ops
with the kernels' plain versions. Exits 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _bench(fn, args, iters, device):
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch kernels")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the default) = the GPU with the CUDA kernels "
                         "(raises without a GPU), cpu = the kernels' plain "
                         "torch versions")
    args = ap.parse_args(argv)

    import torch

    from turingcodec_tpu_torch.decode.reconstruct import (
        dequant_block, inverse_transform)
    from turingcodec_tpu_torch.encode.device_analysis import resolve_device
    from turingcodec_tpu_torch.ops.inter import (
        interp_luma_all_phases, interp_luma_all_phases_np)
    from turingcodec_tpu_torch.ops.intra import (
        intra_predict_all_modes, intra_predict_all_modes_np)
    from turingcodec_tpu_torch.ops.metrics import (sad_batch, satd_batch,
                                                   satd_np, ssd_batch)
    from turingcodec_tpu_torch.ops.quant import quant_batch
    from turingcodec_tpu_torch.ops.transform import (
        dequant_idct_add, forward_transform_batch, forward_transform_np,
        tu_kind)

    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {dev} ({name})", file=sys.stderr)
    rng = np.random.default_rng(0)
    b = args.batch
    failures = 0

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def report(label, ok, t, work, unit):
        nonlocal failures
        if not ok:
            failures += 1
        rate = work / t
        print(f"{label:<28} {'OK ' if ok else 'FAIL'} {t * 1e3:8.3f} ms  "
              f"{rate / 1e9:8.2f} G{unit}/s")

    # forward transforms
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        d = rng.integers(-500, 500, (b, n, n)).astype(np.int32)
        dd = up(d)
        got = forward_transform_batch(dd, 8, False).cpu().numpy()
        ok = all(np.array_equal(got[i], forward_transform_np(d[i], 8, False))
                 for i in range(min(b, 8)))
        t = _bench(forward_transform_batch, (dd, 8, False), args.iters, dev)
        report(f"forward_dct_{n}x{n}", ok, t, b * n * n, "samp")

    # residuals: b TUs of one size at mixed QPs, tiled over a luma plane,
    # dequantized, inverse transformed and added to the predicted samples
    # in one dequant_idct_add call (one kernel launch on the card); every
    # TU against the numpy oracle
    small = np.zeros((4, 4), np.int16)
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        cols = int(np.ceil(np.sqrt(b)))
        lv = rng.integers(-8, 9, (-(-b // cols) * n, cols * n)).astype(
            np.int16)
        pred = rng.integers(0, 256, lv.shape).astype(np.int16)
        xs, ys = np.arange(b) % cols * n, np.arange(b) // cols * n
        qps = rng.integers(0, 52, b)
        table = np.stack([xs, ys, qps, np.full(b, tu_kind(0, log2, 0))],
                         1).astype(np.int32)
        want = [np.clip(pred[y:y + n, x:x + n] + inverse_transform(
            dequant_block(lv[y:y + n, x:x + n], int(q), 8, log2), 8, False),
            0, 255) for x, y, q in zip(xs, ys, qps)]
        coeff = [up(lv), up(small), up(small)]
        planes = [up(pred.copy()), up(small.copy()), up(small.copy())]
        got = dequant_idct_add(coeff, planes, table, (8, 8, 8))[0]
        got = got.cpu().numpy()
        ok = all(np.array_equal(got[y:y + n, x:x + n], w_)
                 for x, y, w_ in zip(xs, ys, want))
        t = _bench(dequant_idct_add, (coeff, planes, table, (8, 8, 8)),
                   args.iters, dev)
        report(f"dequant_idct_{n}x{n}", ok, t, b * n * n, "samp")

    # quant
    lv = rng.integers(-3000, 3000, (b, 16, 16)).astype(np.int32)
    qp = np.full(b, 26, np.int32)
    rnd = np.full(b, 171 << 6, np.int32)
    t = _bench(quant_batch, (up(lv), up(qp), 8, 4, up(rnd)), args.iters,
               dev)
    report("quant_16x16", True, t, b * 256, "coef")

    # metrics
    a8 = rng.integers(0, 256, (b, 16, 16)).astype(np.int32)
    b8 = rng.integers(0, 256, (b, 16, 16)).astype(np.int32)
    ok = int(satd_batch(up(a8), up(b8), 8)[0]) == satd_np(a8[0], b8[0], 8)
    t = _bench(sad_batch, (up(a8), up(b8)), args.iters, dev)
    report("sad_16x16", True, t, b * 256, "samp")
    t = _bench(satd_batch, (up(a8), up(b8), 8), args.iters, dev)
    report("satd8_16x16", ok, t, b * 256, "samp")
    t = _bench(ssd_batch, (up(a8), up(b8)), args.iters, dev)
    report("ssd_16x16", True, t, b * 256, "samp")

    # intra all modes
    for n in (8, 16, 32):
        rt = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
        rl = rng.integers(0, 256, (b, 2 * n + 1)).astype(np.int32)
        co = rng.integers(0, 256, b).astype(np.int32)
        got = intra_predict_all_modes(up(rt), up(rl), up(co), n)
        ok = np.array_equal(got[:2].cpu().numpy(), intra_predict_all_modes_np(
            rt[:2], rl[:2], co[:2], n))
        t = _bench(intra_predict_all_modes, (up(rt), up(rl), up(co), n),
                   args.iters, dev)
        report(f"intra35_{n}x{n}", ok, t, b * 35 * n * n, "samp")

    # interpolation all phases
    w = h = 16
    win = rng.integers(0, 256, (b, h + 7, w + 7)).astype(np.int16)
    got = interp_luma_all_phases(up(win), w, h).cpu().numpy()
    ok = np.array_equal(got[:2].astype(np.int64),
                        interp_luma_all_phases_np(win[:2], w, h))
    t = _bench(interp_luma_all_phases, (up(win), w, h), args.iters, dev)
    report("interp16_luma_16x16", ok, t, b * 16 * w * h, "samp")

    # native SATD kernels (havoc_test analogue: optimized vs C template,
    # bit-exact required, ns/block reported)
    from turingcodec_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        lib.tc_satd_selftest.argtypes = [ctypes.c_int, ctypes.c_void_p]
        out = np.zeros(2, np.int64)
        iters = 20000
        lib.tc_satd_selftest(iters, out.ctypes.data)
        ok = out[0] == 0
        if not ok:
            failures += 1
        print(f"satd8_native      {'OK ' if ok else 'FAIL'}  "
              f"{out[1] / iters / 16:6.2f} ns/blk")

    print("ALL OK" if not failures else f"{failures} FAILURES")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
