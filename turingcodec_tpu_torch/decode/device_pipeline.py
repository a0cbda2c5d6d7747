"""Chained device decode pipeline: MC -> residual add -> (host intra) ->
deblock -> SAO with every intermediate resident on the device and one
device->host pull of the three planes per picture (two more transfers when
the picture has intra CUs). Port of
`turingcodec_tpu/decode/device_pipeline.py`.

It keeps a device-resident DPB: each reconstructed picture's planes stay
on the device, and MC reads its reference planes there in place, through
a table of their addresses, instead of re-uploading or stacking them per
picture (the device-resident DPB of SURVEY.md section 7 stage 6). MC is
one ops/inter.mc_picture launch a picture with inter blocks, from the
plan's dense motion maps (one pinned copy) into the picture's planes,
which start as zeros allocated on the device.

The decoder runs it for every picture when it is given a device
(`Decoder(device=...)`). Bit-exact with the host path. Outside the
reference's envelope (non-4:2:0, scaling lists, PCM) decode_picture_device
returns None and the caller runs the host path; `pictures` and
`envelope_host` count the two outcomes.

With TURING_TPU_PIPELINE_TRACE set, each picture's stages (mc, residual,
intra, deblock, sao, pull) are timed on the host clock, the device
synchronised at every probe: each probe prints the time since the
picture's start to stderr and adds its stage's seconds to `stage_seconds`.
The port's trace (utils/profiler.py) has a span at each of the same
stages (dec.mc, dec.residual, dec.intra_host, dec.deblock, dec.sao,
dec.pull), with dec.upload around each upload, and never synchronises.
"""
from __future__ import annotations

import os
import sys
import time
from collections import OrderedDict

import numpy as np
import torch

from turingcodec_tpu_torch.decode.device_recon import _residual_table
from turingcodec_tpu_torch.ops.deblock import deblock_planes_device
from turingcodec_tpu_torch.ops.inter import mc_picture
from turingcodec_tpu_torch.ops.kernel_build import upload_packed
from turingcodec_tpu_torch.ops.sao import sao_picture_device
from turingcodec_tpu_torch.ops.transform import dequant_idct_add
from turingcodec_tpu_torch.utils.profiler import TRACE

# pictures the pipeline decoded, and pictures it left to the host path
# because they lie outside its envelope (counted by the decoder's
# reconstructor for weighted prediction, which never reaches the pipeline)
pictures = 0
envelope_host = 0
# stage -> host-clock seconds summed over the traced pictures
stage_seconds: "dict[str, float]" = {}

# device-resident DPB: id(host luma plane) -> (host planes, device planes).
# Holding the host arrays keeps the ids stable while cached.
_DEV_DPB: "OrderedDict[int, tuple]" = OrderedDict()
_DEV_DPB_MAX = 24


def left_to_host() -> None:
    """Count a picture left to the host path, here and in the trace."""
    global envelope_host
    envelope_host += 1
    TRACE.count("dec.envelope_host")


def _upload(plane: np.ndarray, device) -> torch.Tensor:
    """A copy of a host plane on `device`: never a view of the host array,
    which the host stages go on writing. Sent from pageable memory."""
    with TRACE.span("dec.upload"):
        host = np.ascontiguousarray(plane)
        TRACE.count("dec.upload.pageable_bytes", host.nbytes)
        return torch.from_numpy(host).to(device, copy=True)


def _pull(planes):
    """The planes as new int16 host arrays, in one transfer (into pageable
    memory; the wait for the device's work on them included)."""
    with TRACE.span("dec.pull"):
        flat = torch.cat([p.reshape(-1) for p in planes]).to(
            torch.int16).cpu()
        TRACE.count("dec.pull.pageable_bytes", flat.numel() * 2)
        parts = np.split(flat.numpy(),
                         np.cumsum([p.numel() for p in planes])[:-1])
        return [a.reshape(p.shape) for a, p in zip(parts, planes)]


def _register_dev(planes, dev):
    _DEV_DPB[id(planes[0])] = (tuple(planes), dev)
    while len(_DEV_DPB) > _DEV_DPB_MAX:
        _DEV_DPB.popitem(last=False)


def _dev_planes_for(pic, device):
    ent = _DEV_DPB.get(id(pic.planes[0]))
    if ent is not None and ent[1][0].device == device:
        _DEV_DPB.move_to_end(id(pic.planes[0]))
        return ent[1]
    TRACE.count("dec.ref_uploads")
    dev = tuple(_upload(p, device) for p in pic.planes[:3])
    _register_dev(pic.planes, dev)
    return dev


def _mc_device(plan, ref_lists, planes):
    """Whole-picture MC into the device planes, in place: the plan's dense
    motion maps go up in one pinned copy and one mc_picture launch
    predicts, combines and writes every inter block. Nothing runs for a
    picture without one."""
    inter = ((plan.cu_pred_mode == 0) & (plan.cu_id >= 0)
             & (plan.ref_idx.max(0) >= 0))
    if not inter.any():
        return planes
    device = planes[0].device
    refs = [[_dev_planes_for(p, device)
             for p in (ref_lists[lx] if lx < len(ref_lists) else [])[:16]]
            for lx in (0, 1)]
    for lx in (0, 1):
        if not refs[lx] and (inter & (plan.ref_idx[lx] >= 0)).any():
            raise ValueError(f"inter blocks predict from the empty "
                             f"reference list {lx}")
    maps = upload_packed([inter.view(np.uint8), plan.ref_idx, plan.mv],
                         device, span="dec.upload")
    sps = plan.sps
    planes = mc_picture(planes, refs, *maps,
                        (sps.bit_depth_y, sps.bit_depth_c))
    TRACE.count("dec.mc.fused")
    return planes


def _residuals_device(plan, planes):
    """Every coded inter TU's dequant + inverse transform + add/clip into
    the device planes, in place, as one dequant_idct_add call over the
    picture's TU table (device_recon._inter_residuals_device twin). The
    level planes go up once; nothing runs for a picture without coded
    inter TUs."""
    table = _residual_table(plan)
    if not len(table):
        return planes
    sps = plan.sps
    device = planes[0].device
    coeffs = [_upload(c, device)
              for c in (plan.coeff_y, plan.coeff_cb, plan.coeff_cr)]
    return dequant_idct_add(coeffs, planes, table,
                            (sps.bit_depth_y, sps.bit_depth_c,
                             sps.bit_depth_c))


def decode_picture_device(pr, device):
    """Run the chained device pipeline on `device` for a
    PictureReconstructor.

    Returns the final [y, cb, cr] host planes, or None when the picture
    lies outside the pipeline's envelope (the caller runs the host path)."""
    global pictures
    plan, geom = pr.plan, pr.geom
    sps = plan.sps
    if (sps.chroma_array_type != 1 or pr.scaling is not None
            or plan.pcm_samples):
        left_to_host()
        return None
    trace = bool(os.environ.get("TURING_TPU_PIPELINE_TRACE"))
    t0 = last = time.perf_counter()

    def tp(tag):
        nonlocal last
        if trace:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            stage_seconds[tag] = stage_seconds.get(tag, 0.0) + now - last
            last = now
            print(f"    [pipeline] {tag:10s} +{now - t0:8.4f}s",
                  file=sys.stderr, flush=True)

    with TRACE.span("dec.mc"):
        # zeros, as the host planes start: MC and the host intra write
        # every coded sample
        planes = [torch.zeros(p.shape, dtype=torch.int16, device=device)
                  for p in (pr.ry, pr.rcb, pr.rcr)]
        planes = _mc_device(plan, pr.ref_lists, planes)
        tp("mc")
    with TRACE.span("dec.residual"):
        planes = _residuals_device(plan, planes)
        tp("residual")

    with TRACE.span("dec.intra_host"):
        if ((plan.cu_pred_mode == 1) & (plan.cu_id >= 0)).any():
            # the one serial-by-spec stage: pull, reconstruct intra CUs on
            # the host (native core), push back
            from turingcodec_tpu_torch import native
            pr.ry[:], pr.rcb[:], pr.rcr[:] = _pull(planes)
            if not native.intra_recon(pr):
                for cu in plan.cu_list:
                    if cu.pred_mode == 1:
                        pr._recon_intra_cu(cu)
            planes = [_upload(p, device) for p in (pr.ry, pr.rcb, pr.rcr)]
        tp("intra")

    with TRACE.span("dec.deblock"):
        planes = deblock_planes_device(plan, geom, planes,
                                       span="dec.upload")
        tp("deblock")
    with TRACE.span("dec.sao"):
        if any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
               for sh in plan.slice_headers):
            planes = sao_picture_device(plan, geom, planes, device,
                                        pull=False, span="dec.upload")
        tp("sao")

    out = _pull(planes)
    tp("pull")
    pr.ry, pr.rcb, pr.rcr = out
    _register_dev(out, tuple(planes))
    pictures += 1
    return out
