"""Entry points of the port: one batched encoder step on the card, and a
dry run of every GOP-batched stage on in-repo stream data (the
counterpart of the repository's `__graft_entry__.py`, which drives the
JAX package).

    python -m turingcodec_tpu_torch.entry [--device {cuda,cpu}]
                                          [--frames F] [--rows R]

`entry(device)` returns (step, args): the residual -> forward DCT ->
quantisation -> rate and SATD step over 8 random 32x32 blocks, with its
inputs on the device. `dryrun(n_frames, n_rows, device)` runs each batched
stage once over an F x R mesh on tests/streams/vfy_sweep.hevc and holds
each against the per-picture host ops, raising on any difference.
--device cuda (the default) runs on the GPU and raises without one; cpu
runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from turingcodec_tpu_torch.encode.device_analysis import resolve_device

STREAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "streams", "vfy_sweep.hevc")


def entry(device="cuda"):
    """(step, args): step(ctus, preds, qp, rounding) -> (levels, rate,
    satd) over (B, 32, 32) int32 blocks, the encoder's inner loop; args are
    8 random blocks and predictions (seed 0), QP 26 and rounding 171 << 6,
    on `device`."""
    from turingcodec_tpu_torch.ops.metrics import satd_batch
    from turingcodec_tpu_torch.ops.quant import quant_batch
    from turingcodec_tpu_torch.ops.transform import forward_transform_batch

    def step(ctus, preds, qp, rounding):
        res = (ctus - preds).contiguous()
        coeffs = forward_transform_batch(res, 8, False)
        levels = quant_batch(coeffs, qp, 8, 5, rounding)
        rate = (levels != 0).sum((1, 2), dtype=torch.int32)
        satd = satd_batch(ctus, preds, 8)
        return levels, rate, satd

    dev = resolve_device(device)
    b = 8
    rng = np.random.default_rng(0)

    def up(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    return step, (up(rng.integers(0, 256, (b, 32, 32))),
                  up(rng.integers(0, 256, (b, 32, 32))),
                  up(np.full(b, 26)), up(np.full(b, 171 << 6)))


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def _residual_blocks(plan, want: int):
    """Up to `want` coded 8x8 luma TUs of a picture with their QPs, padded
    with a flat DC block at QP 30 (as the JAX dry run takes them)."""
    tu, cbf = np.asarray(plan.tu_log2), np.asarray(plan.cbf_y)
    ys, xs = np.nonzero(((tu == 3) & (cbf != 0))[::2, ::2])
    blocks, qps = [], []
    for y, x in zip(ys.tolist(), xs.tolist()):
        blk = np.asarray(plan.coeff_y)[8 * y:8 * y + 8, 8 * x:8 * x + 8]
        if blk.any() and len(blocks) < want:
            blocks.append(blk.astype(np.int32))
            qps.append(int(np.asarray(plan.qp_y)[2 * y, 2 * x]))
    while len(blocks) < want:
        blocks.append(np.eye(8, dtype=np.int32))
        qps.append(30)
    return np.stack(blocks), np.asarray(qps, np.int32)


def dryrun(n_frames: int = 4, n_rows: int = 2, device="cuda", log=print):
    """Build an n_frames x n_rows mesh on `device` and run each batched
    stage once, holding it against the per-picture host ops: the analysis
    step (against per-frame plain calls), GOP MC, residuals, deblocking and
    SAO on vfy_sweep's own pictures (against the host decoder's ops and
    planes), the seed and dense analysis of consecutive picture pairs
    (against the host encoder's twins), and the overlap encode with 3 and
    1 pictures in flight (identical bytes). Returns the checks' names."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.encode.device_analysis import (
        analysis_frames_sharded, seed_fields_frames_sharded)
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    from turingcodec_tpu_torch.encode.inter_search import InterPictureEncoder
    from turingcodec_tpu_torch.ops.inter import mc_block_grid
    from turingcodec_tpu_torch.ops.sao import _sao_plane
    from turingcodec_tpu_torch.ops.transform import dequant_inverse_transform
    from turingcodec_tpu_torch.parallel import gop_decode as gd
    from turingcodec_tpu_torch.parallel.mesh import (analysis_step,
                                                     make_mesh,
                                                     sharded_analysis)
    from turingcodec_tpu_torch.tools.scaling import (gather_workloads,
                                                     stack_workloads)
    dev = resolve_device(device)
    mesh = make_mesh(n_frames, n_rows, dev)
    f = n_frames
    done = []
    rng = np.random.default_rng(1)

    # the encoder analysis step, against each frame's plain call
    shape = (f, n_rows, 2, 32, 32)
    ctus, preds = (torch.as_tensor(rng.integers(0, 256, shape),
                                   dtype=torch.int32) for _ in range(2))
    rate, dist, tr, td = sharded_analysis(mesh)(ctus.to(dev), preds.to(dev),
                                                26)
    for i in range(f):
        r1, d1, _, _ = analysis_step(ctus[i:i + 1], preds[i:i + 1], 26)
        _check(torch.equal(rate[i:i + 1].cpu(), r1)
               and torch.equal(dist[i:i + 1].cpu(), d1),
               "analysis step differs from the per-frame plain call")
    _check(int(tr) == int(rate.sum()) and int(td) == int(dist.sum()),
           "analysis totals")
    done.append("analysis_step")

    with open(STREAM, "rb") as fh:
        data = fh.read()
    # GOP MC on the stream's own inter pictures, against per-picture calls
    works = gather_workloads(data, f)
    _check(len(works) >= f, f"{len(works)} inter pictures for {f} frames")
    refs, cols, nb = stack_workloads(works[:f])
    out = gd.sharded_gop_mc(mesh)(torch.from_numpy(refs), *(
        torch.from_numpy(cols[k]) for k in ("sel", "xi", "yi", "xf", "yf")))
    for i, wk in enumerate(works[:f]):
        a = [torch.from_numpy(np.asarray(wk[k], np.int32)[None])
             for k in ("sel", "xi", "yi", "xf", "yf")]
        want = mc_block_grid([[torch.from_numpy(wk["refs"])]], *a, 4, 8,
                             8)[0, 0]
        _check(torch.equal(out[i, :nb[i]].cpu(), want),
               "GOP MC differs from the per-picture host op")
    done.append("sharded_gop_mc")

    # residuals of real coded 8x8 TUs, deblocking and SAO of real pictures
    pics = gd.capture_pictures(data)
    caps = pics[1:1 + f]
    _check(len(caps) == f, f"{len(caps)} pictures captured for {f} frames")
    blks, qps = zip(*(_residual_blocks(p["plan"], 2 * n_rows) for p in caps))
    blks, qps = np.stack(blks), np.stack(qps)
    res = gd.sharded_gop_residual(mesh)(torch.from_numpy(blks),
                                        torch.from_numpy(qps))
    for i in range(f):
        want = dequant_inverse_transform(torch.from_numpy(blks[i]),
                                         torch.from_numpy(qps[i]), 8, 3, 0)
        _check(torch.equal(res[i].cpu(), want),
               "GOP residual differs from the per-picture host op")
    done.append("sharded_gop_residual")

    args, (ctb_log2, bd_y, bd_c) = gd.deblock_inputs(caps, dev)
    got = gd.sharded_gop_deblock(mesh, ctb_log2, bd_y, bd_c)(*args)
    for k in range(3):
        _check(np.array_equal(got[k].cpu().numpy(),
                              np.stack([p["post"][k] for p in caps])),
               "GOP deblocking differs from the host decoder's planes")
    done.append("sharded_gop_deblock")

    sao_pics = [p for p in pics if p["sao"] is not None][:f]
    _check(len(sao_pics) == f, "too few SAO pictures")
    for c_idx in range(3):
        stacked, (ctb, bd, sub), _per = gd.sao_inputs(sao_pics, c_idx, dev)
        got = gd.sharded_gop_sao(mesh, ctb, bd, sub)(*stacked)
        _check(np.array_equal(got.cpu().numpy(), np.stack(
            [p["sao"][c_idx] for p in sao_pics])),
            "GOP SAO differs from the host decoder's planes")
    done.append("sharded_gop_sao")

    # seed and dense analysis of consecutive pictures (each referencing
    # the one before, as the overlap encoder's in-flight window does),
    # against the host encoder's twins
    frames = [np.asarray(fr.planes[0]).astype(np.int16) for fr in
              Decoder(device=None).decode_stream(data, max_frames=f + 1)]
    origs, refsf = np.stack(frames[1:f + 1]), np.stack(frames[:f])
    sm, wb, hb = seed_fields_frames_sharded(mesh, origs, refsf)
    sm2, dm2, ds2, wb2, hb2 = analysis_frames_sharded(mesh, origs, refsf, 8)
    for i in range(f):
        henc = InterPictureEncoder.__new__(InterPictureEncoder)
        henc._lr_seed_cache, henc._dense_cache = {}, {}
        henc.orig = [origs[i]]
        host = henc._lowres_seed_field(refsf[i])
        dmh, dsh, wbh, hbh = henc._dense_field(refsf[i])
        _check((wb, hb, wb2, hb2) == (host[1], host[2], wbh, hbh)
               and np.array_equal(sm[i], host[0])
               and np.array_equal(sm2[i], host[0])
               and np.array_equal(dm2[i], dmh)
               and np.array_equal(ds2[i], dsh),
               "batched seed/dense analysis differs from the host twins")
    done += ["seed_fields_frames_sharded", "analysis_frames_sharded"]

    # the overlap encoder's in-flight invariance on the stream's frames
    small = [[np.asarray(p) for p in fr.planes]
             for fr in Decoder(device=None).decode_stream(data, max_frames=4)]

    def encode_overlap(in_flight):
        old = os.environ.get("TURING_TPU_FRAME_THREADS")
        os.environ["TURING_TPU_FRAME_THREADS"] = str(in_flight)
        try:
            enc = Encoder(EncoderConfig(
                width=640, height=360, qp=32, rd_candidates=1,
                search_range=32, gop_m=1, sao=False, frame_overlap=True,
                device=device))
            out = [enc.headers()]
            for fr in small:
                out += [nal for (_i, nal, _r) in enc.push_frame(
                    [p.copy() for p in fr])]
            out += [nal for (_i, nal, _r) in enc.flush()]
            return b"".join(out)
        finally:
            if old is None:
                os.environ.pop("TURING_TPU_FRAME_THREADS", None)
            else:
                os.environ["TURING_TPU_FRAME_THREADS"] = old

    _check(encode_overlap(3) == encode_overlap(1),
           "overlap encode not in-flight-count invariant")
    done.append("overlap_encode")
    log(f"dryrun on a {f}x{n_rows} mesh of {dev}: {', '.join(done)} "
        f"equal to the per-picture host ops")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch entry")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--rows", type=int, default=2)
    args = ap.parse_args(argv)
    step, inputs = entry(args.device)
    levels, rate, satd = step(*inputs)
    print(f"entry: levels {tuple(levels.shape)}, rate {rate.tolist()}, "
          f"satd {satd.tolist()}")
    dryrun(args.frames, args.rows, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
