"""GOP-batched decode MC on real bitstream workloads (port of
`turingcodec_tpu/tools/scaling.py`).

Usage:
    python -m turingcodec_tpu_torch.tools.scaling [--frames N] [--mesh FxR]
                                                  [--device {cuda,cpu}]
                                                  [stream.hevc]

What it does:
  1. Host parse and decode of the stream, capturing N inter pictures'
     4x4-block luma MC workloads (list 0) from their plans.
  2. Stacks them into (F, B) tensors and runs the GOP MC step of
     parallel/gop_decode.py over a (frame, row) mesh, which on one card is
     one mc_block_grid launch for all F pictures.
  3. Holds every picture's result against the per-picture call on the same
     device, and reports the wall time of the batched step.

The default stream is tests/streams/vfy_sweep.hevc (8 inter pictures).
--device cuda (the default) runs on the GPU and raises without one; cpu
runs the kernel's plain version. Exits 0 only when the batched MC equals
the per-picture calls.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

STREAM = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "streams", "vfy_sweep.hevc")


def gather_workloads(stream: bytes, n_frames: int):
    """Host parse: per-picture luma MC workloads (list 0, its first four
    references) from the plans of the first n_frames inter pictures."""
    import turingcodec_tpu_torch.decode.picture_recon as pr
    from turingcodec_tpu_torch.decode.decoder import Decoder

    works = []
    orig_run = pr.PictureReconstructor.run

    def hooked(self):
        plan = self.plan
        inter = (plan.cu_pred_mode == 0) & (plan.cu_id >= 0) & (
            plan.ref_idx[0] >= 0)
        if (len(works) < n_frames and inter.any() and self.ref_lists
                and self.ref_lists[0]):
            by4, bx4 = np.nonzero(inter)
            r = plan.ref_idx[0, by4, bx4].astype(np.int32)
            mvx = plan.mv[0, by4, bx4, 0].astype(np.int32)
            mvy = plan.mv[0, by4, bx4, 1].astype(np.int32)
            refs = np.stack([p.planes[0] for p in self.ref_lists[0][:4]])
            works.append(dict(
                refs=refs.astype(np.int16),
                sel=np.minimum(np.maximum(r, 0), refs.shape[0] - 1),
                xi=bx4.astype(np.int32) * 4 + (mvx >> 2),
                yi=by4.astype(np.int32) * 4 + (mvy >> 2),
                xf=mvx & 3, yf=mvy & 3))
        return orig_run(self)

    pr.PictureReconstructor.run = hooked
    try:
        for _f in Decoder(device=None).decode_stream(stream):
            if len(works) >= n_frames:
                break
    finally:
        pr.PictureReconstructor.run = orig_run
    return works


def stack_workloads(works):
    """(refs (F, R, H, W) int16 with absent references zero, {sel, xi, yi,
    xf, yf: (F, B) int32} padded with zeros to the largest B, real block
    counts)."""
    f = len(works)
    bmax = max(len(w["sel"]) for w in works)
    rmax = max(w["refs"].shape[0] for w in works)
    hh, ww = works[0]["refs"].shape[1:]
    refs = np.zeros((f, rmax, hh, ww), np.int16)
    cols = {k: np.zeros((f, bmax), np.int32)
            for k in ("sel", "xi", "yi", "xf", "yf")}
    for i, wk in enumerate(works):
        refs[i, :wk["refs"].shape[0]] = wk["refs"]
        for k in cols:
            cols[k][i, :len(wk[k])] = wk[k]
    return refs, cols, [len(w["sel"]) for w in works]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch scaling")
    ap.add_argument("stream", nargs="?", default=STREAM)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--mesh", default=None,
                    help="FxR (default: one frame cell per picture, 1 row)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import torch

    from turingcodec_tpu_torch.encode.device_analysis import resolve_device
    from turingcodec_tpu_torch.ops.inter import mc_block_grid
    from turingcodec_tpu_torch.parallel.gop_decode import sharded_gop_mc
    from turingcodec_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    with open(args.stream, "rb") as f:
        works = gather_workloads(f.read(), args.frames)
    t_parse = time.perf_counter() - t0
    if not works:
        print("no inter pictures in the stream")
        return 1
    if args.mesh:
        f_ax, r_ax = (int(v) for v in args.mesh.split("x"))
    else:
        f_ax, r_ax = len(works), 1
    if len(works) < f_ax:
        print(f"only {len(works)} inter pictures; shrink the mesh")
        f_ax, r_ax = len(works), 1
    works = works[:(len(works) // f_ax) * f_ax]
    print(f"device: {dev}  mesh: frame={f_ax} row={r_ax} (every cell on "
          f"{dev})")
    print(f"host parse+decode of {len(works)} inter pictures: "
          f"{t_parse:.2f} s")

    refs, cols, nb = stack_workloads(works)
    step = sharded_gop_mc(make_mesh(f_ax, r_ax, dev), bs=4, taps=8,
                          bit_depth=8)
    r_d = torch.from_numpy(refs).to(dev)
    c_d = [torch.from_numpy(cols[k]).to(dev)
           for k in ("sel", "xi", "yi", "xf", "yf")]
    step(r_d, *c_d)        # warm-up: builds and loads the kernel
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(r_d, *c_d)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_mc = time.perf_counter() - t0
    blocks = int(sum(nb))
    print(f"GOP MC: {len(works)} pictures x {refs.shape[1]} references x "
          f"{cols['sel'].shape[1]} blocks ({blocks} real) in "
          f"{t_mc * 1e3:.3f} ms (host clock, synchronised)")

    ok = True
    for i, wk in enumerate(works):
        a = [torch.from_numpy(np.asarray(wk[k], np.int32)[None]).to(dev)
             for k in ("sel", "xi", "yi", "xf", "yf")]
        want = mc_block_grid([[torch.from_numpy(wk["refs"]).to(dev)]], *a,
                             4, 8, 8)[0, 0]
        ok &= bool(torch.equal(out[i, :nb[i]], want))
    print("batched == per-picture:", "BIT-EXACT" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
