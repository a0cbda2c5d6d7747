"""Chained device decode pipeline: MC -> residual add -> (host intra) ->
deblock -> SAO with every intermediate resident on the device and one
device->host pull of the three planes per picture (two more transfers when
the picture has intra CUs). Port of
`turingcodec_tpu/decode/device_pipeline.py`.

It keeps a device-resident DPB: each reconstructed picture's planes stay
on the device, and MC reads its reference planes there in place, through
a table of their addresses, instead of re-uploading or stacking them per
picture (the device-resident DPB of SURVEY.md section 7 stage 6).

The decoder runs it for every picture when it is given a device
(`Decoder(device=...)`). Bit-exact with the host path. Outside the
reference's envelope (non-4:2:0, scaling lists, PCM) decode_picture_device
returns None and the caller runs the host path; `pictures` and
`envelope_host` count the two outcomes.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from turingcodec_tpu_torch.decode.device_recon import (
    _inter_blocks, _predict, _residual_table)
from turingcodec_tpu_torch.ops.deblock import deblock_planes_device
from turingcodec_tpu_torch.ops.sao import sao_picture_device
from turingcodec_tpu_torch.ops.transform import dequant_idct_add

# pictures the pipeline decoded, and pictures it left to the host path
# because they lie outside its envelope (counted by the decoder's
# reconstructor for weighted prediction, which never reaches the pipeline)
pictures = 0
envelope_host = 0

# device-resident DPB: id(host luma plane) -> (host planes, device planes).
# Holding the host arrays keeps the ids stable while cached.
_DEV_DPB: "OrderedDict[int, tuple]" = OrderedDict()
_DEV_DPB_MAX = 24


def _upload(plane: np.ndarray, device) -> torch.Tensor:
    """A copy of a host plane on `device`: never a view of the host array,
    which the host stages go on writing."""
    return torch.from_numpy(np.ascontiguousarray(plane)).to(device,
                                                            copy=True)


def _pull(planes):
    """The planes as new int16 host arrays, in one transfer."""
    flat = torch.cat([p.reshape(-1) for p in planes]).to(torch.int16).cpu()
    parts = np.split(flat.numpy(), np.cumsum([p.numel() for p in planes])[:-1])
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
    dev = tuple(_upload(p, device) for p in pic.planes[:3])
    _register_dev(pic.planes, dev)
    return dev


def _scatter_blocks(plane, by, bx, blocks, bs):
    """Scatter disjoint bs-aligned (B, bs, bs) blocks at min-block coords
    (by, bx) into the (H, W) plane, in place; returns the plane."""
    h, w = plane.shape
    pr = plane.view(h // bs, bs, w // bs, bs).permute(0, 2, 1, 3)
    pr[by.long(), bx.long()] = blocks.to(plane.dtype)
    return plane


def _mc_device(plan, geom, ref_lists, planes):
    """Whole-picture MC into the device planes (device_recon twin with the
    scatter on the device)."""
    blocks = _inter_blocks(plan)
    if blocks is None:
        return planes
    device = planes[0].device
    refs = [[_dev_planes_for(p, device)
             for p in (ref_lists[lx] if lx < len(ref_lists) else [])[:16]]
            for lx in (0, 1)]
    by4, bx4 = blocks
    preds = _predict(plan, by4, bx4, refs, device)
    jb = torch.from_numpy(np.stack([by4, bx4]).astype(np.int32)).to(device)
    return [_scatter_blocks(p, jb[0], jb[1], pred, bs)
            for p, pred, bs in zip(planes, preds, (4, 2, 2))]


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
    global pictures, envelope_host
    plan, geom = pr.plan, pr.geom
    sps = plan.sps
    if (sps.chroma_array_type != 1 or pr.scaling is not None
            or plan.pcm_samples):
        envelope_host += 1
        return None

    planes = [_upload(p, device) for p in (pr.ry, pr.rcb, pr.rcr)]
    planes = _mc_device(plan, geom, pr.ref_lists, planes)
    planes = _residuals_device(plan, planes)

    if ((plan.cu_pred_mode == 1) & (plan.cu_id >= 0)).any():
        # the one serial-by-spec stage: pull, reconstruct intra CUs on the
        # host (native core), push back
        from turingcodec_tpu_torch import native
        pr.ry[:], pr.rcb[:], pr.rcr[:] = _pull(planes)
        if not native.intra_recon(pr):
            for cu in plan.cu_list:
                if cu.pred_mode == 1:
                    pr._recon_intra_cu(cu)
        planes = [_upload(p, device) for p in (pr.ry, pr.rcb, pr.rcr)]

    planes = deblock_planes_device(plan, geom, planes)
    if any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
           for sh in plan.slice_headers):
        planes = sao_picture_device(plan, geom, planes, device, pull=False)

    out = _pull(planes)
    pr.ry, pr.rcb, pr.rcr = out
    _register_dev(out, tuple(planes))
    pictures += 1
    return out
