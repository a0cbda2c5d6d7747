"""The encoder's SAO statistics on a device: per CTB of each component,
the counts and error sums that SAO estimation decides from
(native/enc_core.cpp SaoStats, gathered on the host by tc_sao_gather).

`sao_stats` takes a picture's source and deblocked planes as tensors on
one device: CUDA tensors launch the CUDA kernel in `csrc/sao_stats.cu`
(its header states why it was added, what bounds it on an H100 and its
design) once for every CTB and component; CPU tensors take the plain torch
version `sao_stats_plane` per component. The raster-order decision over
the statistics stays on the host (native tc_sao_decide, called by
encode/sao_search.py).

Layout: 96 int32 a (CTB, component): per edge class eo and category k
(1..4) the count at [eo*4 + k-1] and the error sum (source minus
deblocked) at [16 + eo*4 + k-1], of the samples whose two neighbours along
eo lie in the picture; per band b (sample >> (bd - 5)) the count at
[32 + b] and the error sum at [64 + b].
"""
from __future__ import annotations

import ctypes

import torch

from turingcodec_tpu_torch.ops import kernel_build
from turingcodec_tpu_torch.ops.sao import _EO_A, _REMAP

# kernel launches since import (or since a caller reset it to 0): one per
# sao_stats call on the card
launches = 0
_LAUNCH = None
N_STATS = 96


def sao_stats_plane(orig, rec, ctb, bd, hc, wc):
    """The plain version, one component: orig and rec (h, w) int16 planes,
    CTBs of ctb samples a side on a grid of hc x wc (CTBs past the plane
    stay zero); returns (hc, wc, 96) int32."""
    h, w = rec.shape
    dev = rec.device
    r = rec.to(torch.int64)
    err = orig.to(torch.int64) - r
    ctb_id = ((torch.arange(h, device=dev) // ctb)[:, None] * wc
              + (torch.arange(w, device=dev) // ctb)[None, :])
    out = torch.zeros(hc * wc * N_STATS, dtype=torch.int64, device=dev)
    rp = torch.nn.functional.pad(r, (1, 1, 1, 1))
    remap = torch.as_tensor(_REMAP, device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    for eo, (ady, adx) in enumerate(_EO_A):
        a = rp[1 + ady:1 + ady + h, 1 + adx:1 + adx + w]
        b = rp[1 - ady:1 - ady + h, 1 - adx:1 - adx + w]
        valid = ((ys + ady >= 0) & (ys + ady < h) & (ys - ady >= 0)
                 & (ys - ady < h) & (xs + adx >= 0) & (xs + adx < w)
                 & (xs - adx >= 0) & (xs - adx < w))
        cls = remap[2 + torch.sign(r - a) + torch.sign(r - b)]
        m = valid & (cls > 0)
        key = (ctb_id * N_STATS + eo * 4 + cls - 1)[m]
        out.index_add_(0, key, torch.ones_like(key))
        out.index_add_(0, key + 16, err[m])
    key = (ctb_id * N_STATS + 32 + ((r >> (bd - 5)) & 31)).reshape(-1)
    out.index_add_(0, key, torch.ones_like(key))
    out.index_add_(0, key + 32, err.reshape(-1))
    return out.view(hc, wc, N_STATS).to(torch.int32)


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("sao_stats").sao_stats_launch
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p, p]
        _LAUNCH = fn
    return _LAUNCH


def _launch(orig, rec, ctbs, bds, hc, wc):
    global launches
    dev = rec[0].device
    planes = [p.contiguous() for p in orig + rec]
    if any(p.dtype != torch.int16 or p.device != dev for p in planes):
        raise TypeError("int16 planes on one device required")
    if any(o.shape != r.shape for o, r in zip(orig, rec)):
        raise ValueError("source and deblocked planes differ in shape")
    n = len(rec)
    out = torch.empty((hc, wc, n, N_STATS), dtype=torch.int32, device=dev)
    ptrs = [(ctypes.c_void_p * n)(*(p.data_ptr() for p in half))
            for half in (planes[:n], planes[n:])]
    dims = (ctypes.c_int * (4 * n))(*(
        v for p, c, bd in zip(planes[n:], ctbs, bds)
        for v in (p.shape[0], p.shape[1], c.bit_length() - 1, bd)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher()(ctypes.cast(ptrs[0], ctypes.c_void_p),
                         ctypes.cast(ptrs[1], ctypes.c_void_p),
                         ctypes.cast(dims, ctypes.c_void_p), n, hc, wc,
                         out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sao_stats launch failed: CUDA error {rc}")
    launches += 1
    return out


def sao_stats(orig, rec, ctb, bd_y, bd_c):
    """The statistics of every CTB of a 4:2:0 or monochrome picture: orig
    and rec its source and deblocked planes, [y] or [y, cb, cr] (h, w)
    int16 tensors on one device (the chroma half the luma's sides); ctb
    the luma CTB side (chroma CTBs half of it), bd_y and bd_c the bit
    depths. Returns (hc, wc, C, 96) int32 on that device, hc x wc the luma
    CTB grid. CPU tensors take sao_stats_plane per component; CUDA tensors
    launch the kernel once (CTBs of 16 to 64, bit depths 8..16), and a
    failed build or launch raises."""
    n = len(rec)
    if n not in (1, 3) or len(orig) != n:
        raise ValueError(f"{n} planes: 1 (monochrome) or 3 (4:2:0)")
    ctbs, bds = [ctb, ctb // 2, ctb // 2][:n], [bd_y, bd_c, bd_c][:n]
    h, w = rec[0].shape
    hc, wc = -(-h // ctb), -(-w // ctb)
    if rec[0].device.type == "cpu":
        return torch.stack([sao_stats_plane(o, r, c, bd, hc, wc)
                            for o, r, c, bd in zip(orig, rec, ctbs, bds)],
                           dim=2)
    return _launch(list(orig), list(rec), ctbs, bds, hc, wc)
