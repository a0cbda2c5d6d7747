"""GOP-batched decode stages: the port of
`turingcodec_tpu/parallel/gop_decode.py`.

The JAX package vmaps each per-picture decode stage over the pictures of
a GOP and shards the "frame" axis over a device mesh (the reference's
--concurrent-frames). On one card the frame axis is a batch dimension:

- MC: one `mc_block_grid` launch for all F pictures, their references
  laid end to end in one list of F * R planes;
- residuals: one launch of the residual kernel (`dequant_idct_add`, its
  int16-clip instance over zero planes) for all F * N blocks;
- deblocking and SAO: the per-picture torch code under torch.func.vmap,
  so each of its ops runs once over the F pictures.

Each `sharded_gop_*` takes the mesh and returns the step with the JAX
step's arguments and shapes; `gop_*` are the same steps on the tensors'
own device.
"""
from __future__ import annotations

import numpy as np
import torch

from turingcodec_tpu_torch.ops.deblock import deblock_device, plan_tensors
from turingcodec_tpu_torch.ops.inter import mc_block_grid
from turingcodec_tpu_torch.ops.sao import (_picture_maps, _sao_plane,
                                           sao_plane_args)
from turingcodec_tpu_torch.ops.transform import dequant_idct_add, tu_kind


def gop_mc(refs, sel, xi, yi, xf, yf, bs: int = 4, taps: int = 8,
           bit_depth: int = 8) -> torch.Tensor:
    """refs (F, R, H, W) int16; sel/xi/yi/xf/yf (F, B) int32 as in
    mc_block_grid, sel indexing the frame's own R references (clamped to
    them, as the JAX package's per-frame gather clamps). Returns (F, B,
    bs, bs) int32 predictions from one mc_block_grid call, which raises
    beyond its MAX_PLANES references."""
    f, r, hh, ww = refs.shape
    b = sel.shape[1]
    frame_ref0 = torch.arange(f, dtype=torch.int32, device=sel.device) * r
    sel_all = (sel.clamp(0, r - 1) + frame_ref0[:, None]).reshape(1, f * b)
    planes = [[list(refs.contiguous().reshape(f * r, hh, ww).unbind(0))]]
    per_block = [a.to(torch.int32).reshape(1, f * b).contiguous()
                 for a in (xi, yi, xf, yf)]
    out = mc_block_grid(planes, sel_all.contiguous(), *per_block, bs, taps,
                        bit_depth)
    return out[0, 0].reshape(f, b, bs, bs)


def gop_residual(blocks, qps, bit_depth: int = 8,
                 log2_size: int = 3) -> torch.Tensor:
    """(F, N, n, n) int32 levels and (F, N) QPs -> (F, N, n, n) int32
    residuals: flat dequantisation, then the inverse DCT, as the JAX step
    (dequant_batch, inverse_transform_batch). The F * N blocks are one TU
    table over an (F * N * n, n) level plane, one dequant_idct_add call
    onto zero planes with the int16 clip (the residual kernel's second
    instance on the card, its plain version on the CPU)."""
    f, nb, n, _ = blocks.shape
    if n != 1 << log2_size:
        raise ValueError(f"{n}x{n} blocks for log2_size {log2_size}")
    m = f * nb
    dev = blocks.device
    if m == 0:
        return torch.zeros_like(blocks, dtype=torch.int32)
    lo, hi = torch.stack(torch.aminmax(blocks)).tolist()
    if lo < -32768 or hi > 32767:
        raise ValueError("levels outside the int16 range")
    levels = blocks.reshape(m * n, n).to(torch.int16).contiguous()
    table = np.zeros((m, 4), np.int32)
    table[:, 1] = np.arange(m) * n
    table[:, 2] = qps.reshape(m).cpu().numpy()
    table[:, 3] = tu_kind(0, log2_size, 0)
    small = torch.zeros((4, 4), dtype=torch.int16, device=dev)
    planes = [torch.zeros_like(levels), small, small.clone()]
    res = dequant_idct_add([levels, small, small], planes, table,
                           (bit_depth,) * 3, clip=False)[0]
    return res.to(torch.int32).reshape(f, nb, n, n)


def gop_deblock(ry, rcb, rcr, maps, sl, across, ctb_log2: int = 6,
                bd_y: int = 8, bd_c: int = 8):
    """deblock_device over F pictures under torch.func.vmap: ry (F, H, W),
    rcb/rcr (F, H/2, W/2), maps the 11 plan maps and sl the 6 per-slice
    vectors of ops/deblock.plan_tensors, each with a leading F, across (F,)
    bool. Returns the filtered (ry, rcb, rcr), bit-exact with per-picture
    calls."""
    def one(y, cb, cr, m, s, a):
        return deblock_device(y, cb, cr, m, s, ctb_log2, bd_y, bd_c, a)
    return torch.func.vmap(one)(ry, rcb, rcr, tuple(maps), tuple(sl), across)


def gop_sao(src, sao_type, sao_class, sao_off, slice_up, tile_up, enable_s,
            across_s, across_tiles, skip_up, ctb: int = 64, bd: int = 8,
            sub: int = 1):
    """_sao_plane of one component over F pictures under torch.func.vmap:
    src (F, H, W), per-CTB type/class (F, hc, wc), offsets (F, hc, wc, 4 or
    more), sample-resolution slice/tile/skip maps (F, H, W), per-slice
    enable/across (F, S), across_tiles (F,) bool. Bit-exact with
    per-picture calls."""
    def one(s, t, c, o, su, tu, en, ac, at, sk):
        return _sao_plane(s, ctb, bd, sub, t, c, o, su, tu, en, ac, at, sk)
    return torch.func.vmap(one)(src, sao_type, sao_class, sao_off, slice_up,
                                tile_up, enable_s, across_s, across_tiles,
                                skip_up)


def capture_pictures(stream: bytes, max_frames=None):
    """Host decode of `stream`, capturing every picture in decode order as
    {plan, geom, pre: planes before deblocking, post: after it, sao: after
    SAO or None where the picture codes none} (numpy planes)."""
    import turingcodec_tpu_torch.decode.picture_recon as prm
    from turingcodec_tpu_torch.decode.decoder import Decoder
    pics = []
    real_db, real_sao = prm.deblock_picture, prm.sao_picture

    def deblock(plan, geom, ry, rcb, rcr):
        pre = [ry.copy(), rcb.copy(), rcr.copy()]
        out = real_db(plan, geom, ry, rcb, rcr)
        pics.append(dict(plan=plan, geom=geom, pre=pre,
                         post=[ry.copy(), rcb.copy(), rcr.copy()], sao=None))
        return out

    def sao(plan, geom, planes):
        out = real_sao(plan, geom, planes)
        pics[-1]["sao"] = [p.copy() for p in out]
        return out

    prm.deblock_picture, prm.sao_picture = deblock, sao
    try:
        for _f in Decoder(device=None).decode_stream(stream,
                                                     max_frames=max_frames):
            pass
    finally:
        prm.deblock_picture, prm.sao_picture = real_db, real_sao
    return pics


def deblock_inputs(pics, device):
    """gop_deblock's arguments for captured pictures of one geometry and
    slice count: ((ry, rcb, rcr, maps, sl, across), (ctb_log2, bd_y,
    bd_c))."""
    per = [plan_tensors(p["plan"], p["geom"], device) for p in pics]
    planes = tuple(torch.from_numpy(np.stack([p["pre"][k] for p in pics]))
                   .to(device) for k in range(3))
    maps = tuple(torch.stack([m[0][i] for m in per]) for i in range(11))
    sl = tuple(torch.stack([m[1][i] for m in per]) for i in range(6))
    across = torch.tensor([m[2] for m in per], device=device)
    sps = pics[0]["plan"].sps
    return (planes + (maps, sl, across),
            (int(sps.ctb_log2_size_y), int(sps.bit_depth_y),
             int(sps.bit_depth_c)))


def sao_inputs(pics, c_idx, device):
    """gop_sao's arguments for component c_idx of captured pictures of one
    geometry and slice count, on their deblocked planes: (the stacked
    tensors, (ctb, bd, sub), each picture's own _sao_plane arguments)."""
    per = [sao_plane_args(p["plan"], _picture_maps(p["plan"], p["geom"],
                                                    device), c_idx,
                          torch.from_numpy(p["post"][c_idx]).to(device))
           for p in pics]
    stacked = [torch.stack([a[i] for a in per]) for i in range(4, 11)]
    stacked.insert(0, torch.stack([a[0] for a in per]))
    stacked += [torch.tensor([a[11] for a in per], device=device),
                torch.stack([a[12] for a in per])]
    return stacked, per[0][1:4], per


def _on(mesh, step):
    """step with every tensor argument moved to the mesh's device (tuples
    of tensors too)."""
    dev = mesh.device

    def to(a):
        if isinstance(a, (tuple, list)):
            return type(a)(to(x) for x in a)
        return a.to(dev) if isinstance(a, torch.Tensor) else a

    def run(*args):
        return step(*(to(a) for a in args))
    return run


def sharded_gop_mc(mesh, bs: int = 4, taps: int = 8, bit_depth: int = 8):
    """The stacked-GOP MC step on the mesh's device: refs (F, R, H, W);
    sel/xi/yi/xf/yf (F, B). Output (F, B, bs, bs)."""
    return _on(mesh, lambda refs, sel, xi, yi, xf, yf: gop_mc(
        refs, sel, xi, yi, xf, yf, bs, taps, bit_depth))


def sharded_gop_residual(mesh, bit_depth: int = 8, log2_size: int = 3):
    """The stacked residual step: (F, N, n, n) coefficient batches and (F,
    N) QPs -> (F, N, n, n) residual batches."""
    return _on(mesh, lambda blocks, qps: gop_residual(blocks, qps, bit_depth,
                                                      log2_size))


def sharded_gop_deblock(mesh, ctb_log2: int = 6, bd_y: int = 8,
                        bd_c: int = 8):
    """The stacked deblocking step over the frame axis. Inputs (all with a
    leading F): ry (F, H, W), rcb/rcr (F, H/2, W/2), maps = the 11-tuple of
    plan maps, sl = the 6-tuple of per-slice vectors, across (F,) bool."""
    return _on(mesh, lambda ry, rcb, rcr, maps, sl, across: gop_deblock(
        ry, rcb, rcr, maps, sl, across, ctb_log2, bd_y, bd_c))


def sharded_gop_sao(mesh, ctb: int = 64, bd: int = 8, sub: int = 1):
    """The stacked SAO step for one component over the frame axis: src
    (F, H, W), per-CTB sao_type/class (F, hc, wc), offsets (F, hc, wc, 4),
    upsampled slice/tile/skip maps (F, H, W), per-slice enable/across
    vectors (F, S), across_tiles (F,) bool."""
    return _on(mesh, lambda *a: gop_sao(*a, ctb=ctb, bd=bd, sub=sub))
