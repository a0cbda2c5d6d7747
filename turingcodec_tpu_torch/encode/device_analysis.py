"""Encoder pre-analysis stages on a torch device (EncoderConfig.device).

The encoder's per-picture data-parallel analysis runs as torch code on the
chosen device and feeds the sequential host RDO exactly the integers its
own kernels would have produced, so the bitstream is byte-identical with
the host path (integer arithmetic, same tie-breaks):

- lowres pre-ME seed fields (enc_core lowres_prepass /
  inter_search._lowres_seed_field twins): quarter-res exhaustive +/-8 SAD
  per 16x16 block with cost (SAD<<2)+|dx|+|dy| and scan-order tie-breaks,
  then a half-res +/-2 refinement;
- the dense full-pel +/-8 ME field around the seeds (enc_core
  dense_search_rows twin), through the hand-written kernel
  ops/dense_me.dense_me_sweep, which reads the planes directly, with
  every block's 17x17 SAD surface unless TC_NO_ME_SURF is set (the
  switch the host prepass reads): the full-pel search reads its aligned
  probes from it on both paths;
- the 15 subpel planes of each reference (enc_core sp_build_plane twin),
  through the hand-written kernel csrc/subpel_planes.cu;
- the source-referenced 35-mode rank-SATD tables (intra_search
  _mode_satds twin), through the hand-written kernel csrc/rank_satd.cu.

The seed field runs through the hand-written kernel csrc/seed_field.cu,
one launch for any number of pairs. The three kernels' wrappers,
seed_field, subpel_planes and rank_satd_tables, take the plain torch
versions (seed_field_ref, _subpel_planes, _rank_table) for CPU tensors
only; a CUDA tensor launches the kernel or raises. The subpel planes and
rank tables come down into pinned host memory (_to_host); the seeds stay
on the card for the dense sweep.

Every scan with a strict-improvement tie-break becomes a min over the
packed key (cost << 9) | k, k the scan position, so the result does not
depend on the reduction order. The host planes stay numpy (the encoder's
caches key by their id()); each call uploads them and returns numpy int32.
The numpy host twins (subpel_planes_host, rank_satd_tables_host) are the
oracles of the device versions.
"""
from __future__ import annotations

import ctypes
import os
import weakref
from typing import Optional

import numpy as np
import torch

from turingcodec_tpu_torch.ops import kernel_build
from turingcodec_tpu_torch.ops.dense_me import dense_me_sweep, edge_pad
from turingcodec_tpu_torch.ops.metrics import _wht_last
from turingcodec_tpu_torch.utils.profiler import TRACE

_STATIC = {}  # per-geometry index tensors, keyed by shape and device
# the rank kernel's int32 z-scan tables on the card, keyed by the id of
# the caller's array (an encoder's geometry holds its own) and the device;
# an entry leaves with its array
_ZSCAN = {}
# SAD surfaces computed for the encoder's install since import (or since a
# caller reset it to 0): one per distinct reference plane of an inter
# picture, which both lists share when they hold the same picture
surfaces = 0
# kernel launches since import (or since a caller reset them to 0): the
# rank-SATD kernel's, one per table size, the subpel planes kernel's and
# the seed field kernel's, one per call whatever its number of pairs
rank_launches = 0
subpel_launches = 0
seed_launches = 0
RANK_SIZES = (4, 8, 16, 32)

_RANK_LAUNCH = None
_SUBPEL_LAUNCH = None
_SEED_LAUNCH = None


def resolve_device(device) -> Optional[torch.device]:
    """EncoderConfig.device or Decoder's device -> the torch device of the
    device stages, or None for the host path. A CUDA device without a
    usable card raises: the stages never fall back to the host."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def device_enc_enabled(device) -> bool:
    """Whether the analysis stage runs on `device` (None: the host path)."""
    return device is not None


def upload(plane: np.ndarray, device, dtype=torch.int32) -> torch.Tensor:
    """A host sample plane as a `dtype` tensor on `device` (sent as
    int16, from pageable memory)."""
    with TRACE.span("enc.upload"):
        host = np.ascontiguousarray(plane, np.int16)
        TRACE.count("enc.upload.pageable_bytes", host.nbytes)
        return torch.from_numpy(host).to(device).to(dtype)


def _first_min(cost: torch.Tensor) -> torch.Tensor:
    """Index along dim 0 of the first minimum of non-negative integer
    costs: the min of the packed key (cost << 9) | k (dim 0 <= 512)."""
    n = cost.shape[0]
    k = torch.arange(n, device=cost.device).reshape(
        (n,) + (1,) * (cost.dim() - 1))
    return ((cost.to(torch.int64) << 9) | k).min(0).values & 511


def _lowres_plane(src, f, b, wb, hb, border):
    """Twin of enc_core lowres_plane<F,B>: edge-clamped decimation by
    rounded mean, padded to (hb*b, wb*b) + border."""
    h, w = src.shape
    lw, lh = -(-w // f), -(-h // f)
    p = edge_pad(src, 0, lh * f - h, 0, lw * f - w)
    lr = (p.reshape(lh, f, lw, f).sum((1, 3), dtype=torch.int32)
          + f * f // 2) // (f * f)
    # two edge pads compose into one clamp to the decimated plane
    return edge_pad(lr, border, hb * b - lh + border,
                    border, wb * b - lw + border)


def block_dims(w: int, h: int):
    """(wb, hb): the grid of 16x16 blocks the seed and dense fields cover
    (4x4 blocks of the quarter-res plane, edge-padded)."""
    lw, lh = -(-w // 4), -(-h // 4)
    return -(-lw // 4), -(-lh // 4)


def seed_field_ref(orig: torch.Tensor, ref: torch.Tensor, wb: int, hb: int):
    """Plain torch version of seed_field: (orig, ref) int16 or int32 planes
    -> (hb, wb, 2) int32 seed MVs."""
    dev = orig.device
    cur4 = _lowres_plane(orig, 4, 4, wb, hb, 0)
    ref4 = _lowres_plane(ref, 4, 4, wb, hb, 8)
    # quarter-res exhaustive +/-8: all 289 windows at once
    win = ref4.unfold(0, hb * 4, 1).unfold(1, wb * 4, 1)  # (17,17,H,W)
    sad = (cur4 - win).abs().reshape(17, 17, hb, 4, wb, 4).sum(
        (3, 5), dtype=torch.int32)
    a = torch.arange(-8, 9, device=dev, dtype=torch.int32).abs()
    cost = (sad << 2) + (a[:, None] + a[None, :])[:, :, None, None]
    k = _first_min(cost.reshape(289, hb, wb))
    sdy, sdx = k // 17 - 8, k % 17 - 8

    # half-res +/-2 refinement around (2*sdx, 2*sdy) half-pels
    cur8 = _lowres_plane(orig, 2, 8, wb, hb, 0)
    ref8 = _lowres_plane(ref, 2, 8, wb, hb, 24)
    cb = cur8.reshape(hb, 8, wb, 8).permute(0, 2, 1, 3)
    by = torch.arange(hb, device=dev)[:, None]
    bx = torch.arange(wb, device=dev)[None, :]
    chy, chx = 2 * sdy, 2 * sdx
    d = torch.arange(-2, 3, device=dev)
    ay = torch.arange(8, device=dev)
    ys = ((by * 8 + chy + 24)[None, None, :, :, None, None]
          + d[:, None, None, None, None, None]
          + ay[None, None, None, None, :, None])
    xs = ((bx * 8 + chx + 24)[None, None, :, :, None, None]
          + d[None, :, None, None, None, None]
          + ay[None, None, None, None, None, :])
    sad = (cb - ref8[ys, xs]).abs().sum((-2, -1), dtype=torch.int32)
    sx = 2 * (chx + d[None, :, None, None])
    sy = 2 * (chy + d[:, None, None, None])
    cost = (sad << 2) + sx.abs() + sy.abs()          # (5, 5, hb, wb)
    k = _first_min(cost.reshape(25, hb, wb))
    bsx = 2 * (chx + k % 5 - 2)
    bsy = 2 * (chy + k // 5 - 2)
    return torch.stack([bsx, bsy], -1).to(torch.int32)


def seed_field(orig: torch.Tensor, ref: torch.Tensor):
    """(orig, ref) int16 planes, one (h, w) pair or N as (N, h, w), ->
    (hb, wb, 2) or (N, hb, wb, 2) int32 seed MVs, (wb, hb) =
    block_dims(w, h). A CPU tensor takes the plain version seed_field_ref
    (under torch.func.vmap for N pairs); a CUDA tensor launches
    csrc/seed_field.cu once for all N pairs, and a failed build or launch
    (n beyond the kernel's grid among its refusals) raises."""
    global seed_launches, _SEED_LAUNCH
    if (orig.dtype != torch.int16 or ref.dtype != torch.int16
            or orig.shape != ref.shape or orig.dim() not in (2, 3)
            or 0 in orig.shape[-2:]):
        raise ValueError(f"two non-empty (h, w) or (N, h, w) int16 planes of "
                         f"one shape required, got {orig.dtype} "
                         f"{tuple(orig.shape)} and {ref.dtype} "
                         f"{tuple(ref.shape)}")
    if orig.device != ref.device:
        raise ValueError(f"planes on {orig.device} and {ref.device}")
    h, w = orig.shape[-2:]
    wb, hb = block_dims(w, h)
    if orig.device.type == "cpu":
        if orig.dim() == 2:
            return seed_field_ref(orig, ref, wb, hb)
        return torch.func.vmap(lambda a, b: seed_field_ref(a, b, wb, hb))(
            orig, ref)
    if orig.device.type != "cuda":
        raise ValueError(f"unsupported device {orig.device}")
    if not (orig.is_contiguous() and ref.is_contiguous()):
        raise ValueError("contiguous planes required")
    n = orig.shape[0] if orig.dim() == 3 else 1
    out = torch.empty((n, hb, wb, 2), dtype=torch.int32, device=orig.device)
    if n:
        if _SEED_LAUNCH is None:
            _SEED_LAUNCH = _launcher("seed_field", "ppiiipp")
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        with torch.cuda.device(orig.device):
            rc = _SEED_LAUNCH(orig.data_ptr(), ref.data_ptr(), n, w, h,
                              out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"seed_field launch failed: CUDA error {rc}")
        seed_launches += 1
    return out if orig.dim() == 3 else out[0]


def _dense_stage(orig, ref, seeds, w, h, wb, hb, want_surf=False,
                 bit_depth=16):
    """Twin of enc_core dense_search_rows: per 16x16 block, the exhaustive
    +/-8 full-pel SAD winner around the lowres seed, through the
    dense_me_sweep kernel (the samples' bit_depth picks its key; 16 holds
    any int16 planes). Returns ((hb, wb, 2) MVs, (hb, wb) SADs), and with
    want_surf also the (hb*wb, 289) SAD surface."""
    res = dense_me_sweep(orig, ref, seeds, w, h, wb, hb, want_surf,
                         bit_depth=bit_depth)
    res, surf = res if want_surf else (res, None)
    off = res[:, :2].reshape(hb, wb, 2)
    out = (seeds + off, res[:, 2].reshape(hb, wb))
    return out + (surf,) if want_surf else out


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int32).cpu().numpy()


def analysis_device(orig_y: np.ndarray, ref_y: np.ndarray, device,
                    want_surf: bool = False, bit_depth: int = 16):
    """One reference plane's (seed, dense, sad) fields on `device`:
    ((hb, wb, 2), (hb, wb, 2), (hb, wb)) int32 numpy plus wb, hb —
    integer-exact with the host lowres_prepass + dense_prepass. With
    want_surf, a sixth value: the dense sweep's (hb*wb, 289) int32 SAD
    surface, native.dense_analysis's out_surf. bit_depth: that of the
    samples (the encoder's SPS depth; 16 holds any planes, which go up as
    int16 as in the JAX package)."""
    h, w = orig_y.shape
    wb, hb = block_dims(w, h)
    device = resolve_device(device)
    orig = upload(orig_y, device, torch.int16)
    ref = upload(ref_y, device, torch.int16)
    seeds = seed_field(orig, ref)
    dense = _dense_stage(orig, ref, seeds, w, h, wb, hb, want_surf,
                         bit_depth)
    out = (_np32(seeds), _np32(dense[0]), _np32(dense[1]), wb, hb)
    return out + (_np32(dense[2]),) if want_surf else out


def _upload_pairs(origs, refs, device):
    origs, refs = np.asarray(origs), np.asarray(refs)
    if origs.ndim != 3 or origs.shape != refs.shape:
        raise ValueError(f"(N, h, w) origs and refs required, got "
                         f"{origs.shape} and {refs.shape}")
    return (upload(origs, device, torch.int16),
            upload(refs, device, torch.int16))


def seed_fields_frames_batched(origs: np.ndarray, refs: np.ndarray,
                               device="cuda"):
    """The lowres seed fields of N (orig, ref) luma pairs, (N, h, w) each,
    in one batched pass on `device` (one kernel launch on a card): ((N, hb,
    wb, 2) int32 numpy, wb, hb), each pair's field the exact value of
    seed_field_device (the host lowres_prepass)."""
    o, r = _upload_pairs(origs, refs, resolve_device(device))
    wb, hb = block_dims(o.shape[2], o.shape[1])
    return _np32(seed_field(o, r)), wb, hb


def analysis_frames_batched(origs: np.ndarray, refs: np.ndarray,
                            device="cuda", bit_depth: int = 16):
    """The encoder analysis of N (orig, ref) luma pairs, (N, h, w) each:
    the seed fields in one batched pass (one seed_field launch on a card),
    then the dense full-pel fields and their winner SADs, one
    dense_me_sweep launch per pair (the kernel clamps its reads to one
    plane pair). Returns ((N, hb, wb, 2) seeds, (N, hb, wb, 2) dense MVs,
    (N, hb, wb) SADs) int32 numpy and wb, hb, each pair's the exact value
    of analysis_device."""
    o, r = _upload_pairs(origs, refs, resolve_device(device))
    n, h, w = o.shape
    wb, hb = block_dims(w, h)
    seeds = seed_field(o, r)
    dense = [_dense_stage(o[i], r[i], seeds[i], w, h, wb, hb,
                          bit_depth=bit_depth) for i in range(n)]
    dm = torch.stack([d[0] for d in dense]) if n else seeds
    ds = torch.stack([d[1] for d in dense]) if n else seeds[..., 0]
    return _np32(seeds), _np32(dm), _np32(ds), wb, hb


def analysis_frames_sharded(mesh, origs, refs, bit_depth: int = 16):
    """analysis_frames_batched on the mesh's device (the name of the JAX
    package's frame-sharded form)."""
    return analysis_frames_batched(origs, refs, mesh.device, bit_depth)


def seed_fields_frames_sharded(mesh, origs, refs):
    """seed_fields_frames_batched on the mesh's device (the name of the
    JAX package's frame-sharded form)."""
    return seed_fields_frames_batched(origs, refs, mesh.device)


def seed_field_device(orig_y: np.ndarray, ref_y: np.ndarray, device):
    """One reference plane's seed field on `device`: ((hb, wb, 2) int32
    numpy, wb, hb) — the exact value of inter_search._lowres_seed_field /
    enc_core lowres_prepass."""
    h, w = orig_y.shape
    wb, hb = block_dims(w, h)
    device = resolve_device(device)
    seeds = seed_field(upload(orig_y, device, torch.int16),
                       upload(ref_y, device, torch.int16))
    return _np32(seeds), wb, hb


SP_P = 28   # stored-plane pad (enc_core SP_P)
SP_EXT2 = 36  # edge pad so every clamped tap read is a plain slice


def _subpel_planes(ref: torch.Tensor, bd: int) -> torch.Tensor:
    """int32 ref plane -> (15, h+2*SP_P, w+2*SP_P) int16: the 15 fractional
    luma positions interpolated over the padded grid, each value bit-equal
    to enc_core sp_build_plane (edge-replicated padding == per-sample
    coordinate clamping; same >>shift1 / >>6 arithmetic)."""
    from turingcodec_tpu_torch.hevc.tables import LUMA_FILTER
    filt = np.asarray(LUMA_FILTER, np.int32)  # (4 phases, 8 taps)
    h, w = ref.shape
    shift1 = bd - 8
    pw, ph = w + 2 * SP_P, h + 2 * SP_P
    pwe, phe = w + 2 * (SP_P + 4), h + 2 * (SP_P + 4)
    ext2 = edge_pad(ref, SP_EXT2, SP_EXT2, SP_EXT2, SP_EXT2)
    # H-filtered intermediates for xf=1..3 over the full ext grid (rows
    # phe so the 2D V pass can reach its taps)
    hplanes = {}
    for xf in (1, 2, 3):
        acc = sum(int(filt[xf][k]) * ext2[4:4 + phe, 1 + k:1 + k + pwe]
                  for k in range(8))
        hplanes[xf] = acc >> shift1
    out = []
    for yf in range(4):
        for xf in range(4):
            if xf == 0 and yf == 0:
                continue
            if yf == 0:
                p = hplanes[xf][4:4 + ph, 4:4 + pw]
            elif xf == 0:
                acc = sum(int(filt[yf][k]) * ext2[5 + k:5 + k + ph, 8:8 + pw]
                          for k in range(8))
                p = acc >> shift1
            else:
                acc = sum(int(filt[yf][k])
                          * hplanes[xf][1 + k:1 + k + ph, 4:4 + pw]
                          for k in range(8))
                p = acc >> 6
            out.append(p.to(torch.int16))
    return torch.stack(out)


def _to_host(tensors) -> list:
    """Each tensor as numpy. A card's tensors are copied into pinned host
    memory from torch's caching host allocator (one asynchronous copy each,
    then one synchronise); each array is a view that keeps its buffer
    alive, as the native core reads it by pointer while the picture
    encodes, and the allocator takes the buffer back once the array dies."""
    with TRACE.span("enc.download"):
        for t in tensors:
            TRACE.count("enc.download.pageable_bytes"
                        if t.device.type == "cpu"
                        else "enc.download.pinned_bytes",
                        t.numel() * t.element_size())
        out = [t if t.device.type == "cpu" else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True)
            for t in tensors]
        cards = [t.device for t in tensors if t.device.type == "cuda"]
        if cards:
            torch.cuda.current_stream(cards[0]).synchronize()
        return [t.numpy() for t in out]


def _check_plane(plane: torch.Tensor, bd: int):
    if plane.dtype != torch.int16 or plane.dim() != 2 or 0 in plane.shape:
        raise ValueError(f"a non-empty (h, w) int16 plane required, got "
                         f"{plane.dtype} {tuple(plane.shape)}")
    if not plane.is_contiguous():
        raise ValueError("a contiguous plane required")
    if not 8 <= bd <= 16:
        raise ValueError(f"bit depth {bd} unsupported (8..16)")


def _launcher(name: str, args: str):
    """The C entry point <name>_launch of csrc/<name>.cu, its arguments
    spelt p (pointer) or i (int)."""
    fn = getattr(kernel_build.load(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if a == "p" else ctypes.c_int
                   for a in args]
    return fn


def subpel_planes(ref: torch.Tensor, bd: int) -> torch.Tensor:
    """(h, w) int16 plane -> (15, h+2*SP_P, w+2*SP_P) int16, the exact
    sp_build_plane values; bit depths 8..16. A CPU tensor takes the plain
    version _subpel_planes; a CUDA tensor launches csrc/subpel_planes.cu
    once, and a failed build or launch raises."""
    global subpel_launches, _SUBPEL_LAUNCH
    _check_plane(ref, bd)
    if ref.device.type == "cpu":
        return _subpel_planes(ref.to(torch.int32), bd)
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    h, w = ref.shape
    out = torch.empty((15, h + 2 * SP_P, w + 2 * SP_P), dtype=torch.int16,
                      device=ref.device)
    if _SUBPEL_LAUNCH is None:
        _SUBPEL_LAUNCH = _launcher("subpel_planes", "piiipp")
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    with torch.cuda.device(ref.device):
        rc = _SUBPEL_LAUNCH(ref.data_ptr(), w, h, bd, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"subpel_planes launch failed: CUDA error {rc}")
    subpel_launches += 1
    return out


def subpel_planes_device(ref_y: np.ndarray, bd: int, device) -> np.ndarray:
    """The 15 subpel planes of one reference plane, computed on `device`;
    (15, h+2*SP_P, w+2*SP_P) int16 numpy, exact sp_build_plane values (from
    pinned memory on a card)."""
    ref = upload(ref_y, resolve_device(device), torch.int16)
    return _to_host([subpel_planes(ref, bd)])[0]


def subpel_planes_host(ref_y: np.ndarray, bd: int = 8) -> np.ndarray:
    """Vectorized numpy twin of subpel_planes_device / sp_build_plane
    (full-plane oracle for the real-chip exactness check)."""
    from turingcodec_tpu_torch.hevc.tables import LUMA_FILTER
    filt = np.asarray(LUMA_FILTER, np.int32)
    h, w = ref_y.shape
    shift1 = bd - 8
    pw, ph = w + 2 * SP_P, h + 2 * SP_P
    pwe, phe = w + 2 * (SP_P + 4), h + 2 * (SP_P + 4)
    ext2 = np.pad(ref_y.astype(np.int32), SP_EXT2, "edge")
    hplanes = {}
    for xf in (1, 2, 3):
        acc = sum(int(filt[xf][k]) * ext2[4:4 + phe, 1 + k:1 + k + pwe]
                  for k in range(8))
        hplanes[xf] = acc >> shift1 if shift1 else acc
    out = []
    for yf in range(4):
        for xf in range(4):
            if xf == 0 and yf == 0:
                continue
            if yf == 0:
                p = hplanes[xf][4:4 + ph, 4:4 + pw]
            elif xf == 0:
                acc = sum(int(filt[yf][k])
                          * ext2[5 + k:5 + k + ph, 8:8 + pw]
                          for k in range(8))
                p = acc >> shift1 if shift1 else acc
            else:
                acc = sum(int(filt[yf][k])
                          * hplanes[xf][1 + k:1 + k + ph, 4:4 + pw]
                          for k in range(8))
                p = acc >> 6
            out.append(p.astype(np.int16))
    return np.stack(out)


def _rank_grid_refs(plane, zscan, n, bd):
    """Batched source-referenced intra reference samples for every
    in-picture n-aligned block: returns vals (hn*wn, 4n+1) int32 in scan
    order (left bottom-up, corner, top), with spec 8.4.4.2.2
    availability substitution (z-scan positional availability — the
    simple single-slice/no-tile case the prepass supports)."""
    h, w = plane.shape
    hn, wn = h // n, w // n
    m = 4 * n + 1
    tx = np.empty(m, np.int32)
    ty = np.empty(m, np.int32)
    tx[:2 * n + 1] = -1
    tx[2 * n + 1:] = np.arange(2 * n)
    ty[:2 * n] = 2 * n - 1 - np.arange(2 * n)
    ty[2 * n:] = -1
    bx = (np.arange(wn) * n)[None, :, None]
    by = (np.arange(hn) * n)[:, None, None]
    px = bx + tx[None, None, :]
    py = by + ty[None, None, :]
    inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    pxc = np.clip(px, 0, w - 1)
    pyc = np.clip(py, 0, h - 1)
    zcur = zscan[by[:, :, 0] >> 2, bx[:, :, 0] >> 2][:, :, None]
    ok = inb & (zscan[pyc >> 2, pxc >> 2] <= zcur)
    vals = plane[pyc, pxc].astype(np.int32)
    vals = vals.reshape(-1, m)
    ok = ok.reshape(-1, m)
    mid = 1 << (bd - 1)
    any_ok = ok.any(axis=1)
    first = np.argmax(ok, axis=1)
    b = np.arange(vals.shape[0])
    vals[:, 0] = np.where(ok[:, 0], vals[:, 0], vals[b, first])
    ok[:, 0] = True
    vals = np.where(ok, vals, 0)
    src = np.where(ok, np.arange(m)[None, :], 0)
    np.maximum.accumulate(src, axis=1, out=src)
    vals = vals[b[:, None], src]
    vals = np.where(any_ok[:, None], vals, mid)
    return vals


def _filter_grid_refs(vals, n, strong, bd):
    """Batched spec 8.4.4.2.3 reference filtering of scan-order vals
    (B, 4n+1): [1 2 1] smoothing, with the strong bilinear variant at
    n == 32 when the flatness thresholds pass."""
    B, m = vals.shape
    co = vals[:, 2 * n]
    rl = vals[:, :2 * n][:, ::-1]  # rl[i] = p[-1][i] top-down
    rt = vals[:, 2 * n + 1:]
    ft = np.empty_like(rt)
    fl = np.empty_like(rl)
    ft[:, 0] = (co + 2 * rt[:, 0] + rt[:, 1] + 2) >> 2
    fl[:, 0] = (co + 2 * rl[:, 0] + rl[:, 1] + 2) >> 2
    ft[:, 1:2 * n - 1] = (rt[:, :2 * n - 2] + 2 * rt[:, 1:2 * n - 1]
                          + rt[:, 2:] + 2) >> 2
    fl[:, 1:2 * n - 1] = (rl[:, :2 * n - 2] + 2 * rl[:, 1:2 * n - 1]
                          + rl[:, 2:] + 2) >> 2
    ft[:, 2 * n - 1] = rt[:, 2 * n - 1]
    fl[:, 2 * n - 1] = rl[:, 2 * n - 1]
    fc = (rl[:, 0] + 2 * co + rt[:, 0] + 2) >> 2
    if strong and n == 32:
        t1 = np.abs(co + rt[:, 2 * n - 1] - 2 * rt[:, n - 1])
        t2 = np.abs(co + rl[:, 2 * n - 1] - 2 * rl[:, n - 1])
        is_str = (t1 < (1 << (bd - 5))) & (t2 < (1 << (bd - 5)))
        i = np.arange(63)
        st = ((63 - i)[None, :] * co[:, None]
              + (i + 1)[None, :] * rt[:, 63][:, None] + 32) >> 6
        sl = ((63 - i)[None, :] * co[:, None]
              + (i + 1)[None, :] * rl[:, 63][:, None] + 32) >> 6
        ft[:, :63] = np.where(is_str[:, None], st, ft[:, :63])
        fl[:, :63] = np.where(is_str[:, None], sl, fl[:, :63])
        ft[:, 63] = np.where(is_str, rt[:, 63], ft[:, 63])
        fl[:, 63] = np.where(is_str, rl[:, 63], fl[:, 63])
        fc = np.where(is_str, co, fc)
    out = np.empty_like(vals)
    out[:, :2 * n] = fl[:, ::-1]
    out[:, 2 * n] = fc
    out[:, 2 * n + 1:] = ft
    return out


def _grid_mode_satds(orig_blocks, vals, fvals, n, bd):
    """(B, n, n) originals + scan-order refs -> (B, 35) SATDs, matching
    intra_search._mode_satds (per-mode filtered/unfiltered choice, no
    edge filters in the ranking predictions)."""
    from turingcodec_tpu_torch.decode.reconstruct import _HVD_THRES
    from turingcodec_tpu_torch.encode.sweep import _h4, _h8, _stacked_tables
    B = vals.shape[0]
    rl = vals[:, :2 * n][:, ::-1]
    co = vals[:, 2 * n]
    rt = vals[:, 2 * n + 1:]
    x = np.arange(n)
    log2n = int(n).bit_length() - 1
    out = np.empty((B, 35), np.int64)
    block = 8 if n >= 8 else 4
    hb = _h8() if block == 8 else _h4()
    d0 = orig_blocks.astype(np.int32)

    def satd(preds):  # (B, M, n, n) -> (B, M)
        mm = preds.shape[1]
        d = d0[:, None] - preds
        bh = n // block
        d = d.reshape(B, mm, bh, block, bh, block).transpose(
            0, 1, 2, 4, 3, 5)
        t = hb @ d @ hb
        s = np.abs(t).sum(axis=(4, 5))
        s = (s + 2) >> 2 if block == 8 else (s + 1) >> 1
        return s.sum(axis=(2, 3)).astype(np.int64)

    use_f = np.zeros(35, bool)
    if n > 4:
        thres = _HVD_THRES[n]
        for mode in range(35):
            if mode == 1:
                continue
            if mode != 0 and min(abs(mode - 26), abs(mode - 10)) <= thres:
                continue
            use_f[mode] = True

    frl = fvals[:, :2 * n][:, ::-1] if fvals is not None else rl
    fco = fvals[:, 2 * n] if fvals is not None else co
    frt = fvals[:, 2 * n + 1:] if fvals is not None else rt

    # planar + DC from the per-mode-appropriate refs
    def planar(rt_, rl_):
        return (((n - 1 - x)[None, None, :] * rl_[:, :n, None]
                 + (x + 1)[None, None, :] * rt_[:, n][:, None, None]
                 + (n - 1 - x)[None, :, None] * rt_[:, None, :n]
                 + (x + 1)[None, :, None] * rl_[:, n][:, None, None]
                 + n) >> (log2n + 1)).astype(np.int32)

    p0 = planar(frt, frl) if use_f[0] else planar(rt, rl)
    rtd, rld = (frt, frl) if use_f[1] else (rt, rl)
    dc = ((rtd[:, :n].sum(axis=1) + rld[:, :n].sum(axis=1) + n)
          >> (log2n + 1))
    p1 = np.broadcast_to(dc[:, None, None].astype(np.int32),
                         (B, n, n)).copy()
    out[:, 0] = satd(p0[:, None])[:, 0]
    out[:, 1] = satd(p1[:, None])[:, 0]

    # angular modes via the stacked gather tables, one ext per variant
    pos0, fact, neg = _stacked_tables(n)

    def build_ext(rt_, rl_, co_):
        ext = np.empty((B, 33, 3 * n + 2), np.int32)
        ext[:, :16, :n] = np.where(neg[None, :16] < 0, co_[:, None, None],
                                   rt_[:, np.maximum(neg[:16], 0)])
        ext[:, 16:, :n] = np.where(neg[None, 16:] < 0, co_[:, None, None],
                                   rl_[:, np.maximum(neg[16:], 0)])
        ext[:, :, n] = co_[:, None]
        ext[:, :16, n + 1:3 * n + 1] = rl_[:, None, :2 * n]
        ext[:, 16:, n + 1:3 * n + 1] = rt_[:, None, :2 * n]
        ext[:, :16, 3 * n + 1] = rl_[:, 2 * n - 1][:, None]
        ext[:, 16:, 3 * n + 1] = rt_[:, 2 * n - 1][:, None]
        return ext.reshape(B, -1)

    ext_u = build_ext(rt, rl, co)
    ext_f = build_ext(frt, frl, fco) if n > 4 else ext_u
    bidx = np.arange(B)[:, None, None, None]
    pf = pos0[None]
    gu = ext_u[bidx, pf]
    g1u = ext_u[bidx, pf + 1]
    pu = ((32 - fact[None]) * gu + fact[None] * g1u + 16) >> 5
    if n > 4:
        gf = ext_f[bidx, pf]
        g1f = ext_f[bidx, pf + 1]
        pfa = ((32 - fact[None]) * gf + fact[None] * g1f + 16) >> 5
        sel = use_f[2:][None, :, None, None]
        pang = np.where(sel, pfa, pu)
    else:
        pang = pu
    out[:, 2:] = satd(pang.astype(np.int32))
    return out


def rank_satd_tables_host(plane, zscan, bd, strong, sizes=(4, 8, 16, 32)):
    """Source-referenced 35-mode SATD tables for every aligned block of
    each size: {n: (hn, wn, 35) int32}. The exact integers the in-loop
    rank computes at those positions (intra_search._mode_satds /
    enc_core rank_modes sweep with source refs)."""
    plane = np.asarray(plane)
    out = {}
    for n in sizes:
        h, w = plane.shape
        hn, wn = h // n, w // n
        if hn == 0 or wn == 0:
            continue
        vals = _rank_grid_refs(plane, zscan, n, bd)
        fvals = _filter_grid_refs(vals, n, strong, bd) if n > 4 else None
        ob = plane[:hn * n, :wn * n].reshape(hn, n, wn, n) \
            .transpose(0, 2, 1, 3).reshape(-1, n, n)
        satds = _grid_mode_satds(ob, vals, fvals, n, bd)
        out[n] = satds.reshape(hn, wn, 35).astype(np.int32)
    return out


def _rank_static(w, h, n, zscan_np, device):
    """Per-geometry index tensors of the rank program for one size."""
    from turingcodec_tpu_torch.decode.reconstruct import _HVD_THRES
    from turingcodec_tpu_torch.encode.sweep import _stacked_tables
    key = (w, h, n, zscan_np.tobytes(), str(device))
    st = _STATIC.get(key)
    if st is not None:
        return st
    hn, wn = h // n, w // n
    B = hn * wn
    m = 4 * n + 1
    tx = np.empty(m, np.int32)
    ty = np.empty(m, np.int32)
    tx[:2 * n + 1] = -1
    tx[2 * n + 1:] = np.arange(2 * n)
    ty[:2 * n] = 2 * n - 1 - np.arange(2 * n)
    ty[2 * n:] = -1
    bx = (np.arange(wn) * n)[None, :, None]
    by = (np.arange(hn) * n)[:, None, None]
    px = np.broadcast_to(bx + tx[None, None, :], (hn, wn, m)).reshape(B, m)
    py = np.broadcast_to(by + ty[None, None, :], (hn, wn, m)).reshape(B, m)
    inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    pxc = np.clip(px, 0, w - 1)
    pyc = np.clip(py, 0, h - 1)
    zcur = zscan_np[by[:, :, 0] >> 2, bx[:, :, 0] >> 2].reshape(B, 1)
    ok = inb & (zscan_np[pyc >> 2, pxc >> 2] <= zcur)
    pos0, fact, neg = _stacked_tables(n)
    use_f = np.zeros(35, bool)
    if n > 4:
        thres = _HVD_THRES[n]
        for mode in range(35):
            if mode == 1:
                continue
            if mode != 0 and min(abs(mode - 26), abs(mode - 10)) <= thres:
                continue
            use_f[mode] = True

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    st = dict(pyc=t(pyc, torch.int64), pxc=t(pxc, torch.int64),
              ok=t(ok), pos0=t(pos0, torch.int64), fact=t(fact, torch.int32),
              negc=t(np.maximum(neg, 0), torch.int64), neg_is_c=t(neg < 0),
              use_f=use_f, use_f_ang=t(use_f[2:]))
    _STATIC[key] = st
    return st


def _rank_table(p32, st, w, h, n, bd, strong):
    """int32 plane -> (hn, wn, 35) int32 rank-SATD table for one size: the
    torch twin of rank_satd_tables_host (identical integers), with the 33
    angular modes batched."""
    hn, wn = h // n, w // n
    B = hn * wn
    m = 4 * n + 1
    dev = p32.device
    mid = 1 << (bd - 1)
    x = torch.arange(n, device=dev, dtype=torch.int32)
    log2n = int(n).bit_length() - 1
    block = 8 if n >= 8 else 4
    use_f = st["use_f"]

    # reference samples with z-scan availability substitution
    vals = p32[st["pyc"], st["pxc"]]  # (B, m)
    ok = st["ok"]
    any_ok = ok.any(1)
    first = ok.to(torch.int32).argmax(1)
    barange = torch.arange(B, device=dev)
    vals[:, 0] = torch.where(ok[:, 0], vals[:, 0], vals[barange, first])
    ok = ok.clone()
    ok[:, 0] = True
    vals = torch.where(ok, vals, 0)
    src = torch.where(ok, torch.arange(m, device=dev)[None, :], 0)
    src = torch.cummax(src, 1).values
    vals = vals.gather(1, src)
    vals = torch.where(any_ok[:, None], vals, mid)

    rl = vals[:, :2 * n].flip(1)
    co = vals[:, 2 * n]
    rt = vals[:, 2 * n + 1:]
    if n > 4:
        ft0 = (co + 2 * rt[:, 0] + rt[:, 1] + 2) >> 2
        fl0 = (co + 2 * rl[:, 0] + rl[:, 1] + 2) >> 2
        ftm = (rt[:, :2 * n - 2] + 2 * rt[:, 1:2 * n - 1]
               + rt[:, 2:] + 2) >> 2
        flm = (rl[:, :2 * n - 2] + 2 * rl[:, 1:2 * n - 1]
               + rl[:, 2:] + 2) >> 2
        frt = torch.cat([ft0[:, None], ftm, rt[:, 2 * n - 1:]], 1)
        frl = torch.cat([fl0[:, None], flm, rl[:, 2 * n - 1:]], 1)
        fco = (rl[:, 0] + 2 * co + rt[:, 0] + 2) >> 2
        if strong and n == 32:
            t1 = (co + rt[:, 2 * n - 1] - 2 * rt[:, n - 1]).abs()
            t2 = (co + rl[:, 2 * n - 1] - 2 * rl[:, n - 1]).abs()
            is_str = (t1 < (1 << (bd - 5))) & (t2 < (1 << (bd - 5)))
            i = torch.arange(63, device=dev, dtype=torch.int32)
            s_t = ((63 - i)[None, :] * co[:, None]
                   + (i + 1)[None, :] * rt[:, 63][:, None] + 32) >> 6
            s_l = ((63 - i)[None, :] * co[:, None]
                   + (i + 1)[None, :] * rl[:, 63][:, None] + 32) >> 6
            frt = torch.where(is_str[:, None],
                              torch.cat([s_t, rt[:, 63:]], 1), frt)
            frl = torch.where(is_str[:, None],
                              torch.cat([s_l, rl[:, 63:]], 1), frl)
            fco = torch.where(is_str, co, fco)
    else:
        frt, frl, fco = rt, rl, co

    ob = p32[:hn * n, :wn * n].reshape(hn, n, wn, n).permute(
        0, 2, 1, 3).reshape(B, 1, n, n)

    def satd(preds):  # (B, M, n, n) -> (B, M)
        mm = preds.shape[1]
        bh = n // block
        d = (ob - preds).reshape(B, mm, bh, block, bh, block).permute(
            0, 1, 2, 4, 3, 5)
        # H d H summed in absolute value; the transpose between the two
        # passes does not change the sum
        t = _wht_last(_wht_last(d).transpose(-1, -2))
        s = t.abs().sum((-2, -1), dtype=torch.int32)
        s = (s + 2) >> 2 if block == 8 else (s + 1) >> 1
        return s.sum((2, 3), dtype=torch.int32)

    def planar(rt_, rl_):
        return (((n - 1 - x)[None, None, :] * rl_[:, :n, None]
                 + (x + 1)[None, None, :] * rt_[:, n][:, None, None]
                 + (n - 1 - x)[None, :, None] * rt_[:, None, :n]
                 + (x + 1)[None, :, None] * rl_[:, n][:, None, None]
                 + n) >> (log2n + 1))

    p0 = planar(frt, frl) if use_f[0] else planar(rt, rl)
    s0 = satd(p0[:, None])
    rtd, rld = (frt, frl) if use_f[1] else (rt, rl)
    dc = ((rtd[:, :n].sum(1, dtype=torch.int32)
           + rld[:, :n].sum(1, dtype=torch.int32) + n) >> (log2n + 1))
    s1 = satd(dc[:, None, None, None].expand(B, 1, n, n))

    # the 33 angular modes at once: rows 0..15 = modes 2..17 (main ref =
    # LEFT, negative extension from TOP), rows 16.. = modes 18..34
    negc, neg_is_c = st["negc"], st["neg_is_c"]

    def build_ext(rt_, rl_, co_):
        ext = torch.empty((B, 33, 3 * n + 2), dtype=torch.int32, device=dev)
        ext[:, :16, :n] = torch.where(neg_is_c[None, :16],
                                      co_[:, None, None], rt_[:, negc[:16]])
        ext[:, 16:, :n] = torch.where(neg_is_c[None, 16:],
                                      co_[:, None, None], rl_[:, negc[16:]])
        ext[:, :, n] = co_[:, None]
        ext[:, :16, n + 1:3 * n + 1] = rl_[:, None, :2 * n]
        ext[:, 16:, n + 1:3 * n + 1] = rt_[:, None, :2 * n]
        ext[:, :16, 3 * n + 1] = rl_[:, 2 * n - 1][:, None]
        ext[:, 16:, 3 * n + 1] = rt_[:, 2 * n - 1][:, None]
        return ext.reshape(B, -1)

    pos0, fact = st["pos0"], st["fact"]

    def angular(ext):
        return ((32 - fact) * ext[:, pos0] + fact * ext[:, pos0 + 1]
                + 16) >> 5

    pang = angular(build_ext(rt, rl, co))
    if n > 4:
        pfa = angular(build_ext(frt, frl, fco))
        pang = torch.where(st["use_f_ang"][None, :, None, None], pfa, pang)
    sang = satd(pang)
    out = torch.cat([s0, s1, sang], 1)
    return out.reshape(hn, wn, 35).to(torch.int32)


def rank_satd_tables_ref(plane: torch.Tensor, zscan: np.ndarray, bd: int,
                         strong: bool, sizes=RANK_SIZES) -> dict:
    """Plain torch version of rank_satd_tables on the plane's device:
    _rank_table per size."""
    h, w = plane.shape
    p32 = plane.to(torch.int32)
    return {n: _rank_table(p32, _rank_static(w, h, n, np.asarray(zscan),
                                             p32.device),
                           w, h, n, bd, bool(strong))
            for n in sizes if h // n and w // n}


def rank_satd_tables(plane: torch.Tensor, zscan: np.ndarray, bd: int,
                     strong: bool, sizes=RANK_SIZES) -> dict:
    """(h, w) int16 plane -> {n: (h/n, w/n, 35) int32} rank-SATD tables of
    the sizes in `sizes` (of 4, 8, 16, 32; a size with no whole block is
    left out), zscan the (h/4, w/4) z-scan order of the picture's 4x4
    blocks; bit depths 8..16. A CPU tensor takes the plain version
    _rank_table; a CUDA tensor launches csrc/rank_satd.cu once per size,
    the tables views of one buffer, and a failed build or launch raises."""
    global rank_launches, _RANK_LAUNCH
    _check_plane(plane, bd)
    zscan = np.asarray(zscan)
    h, w = plane.shape
    if (zscan.ndim != 2 or zscan.shape[0] * 4 < h
            or zscan.shape[1] * 4 < w):
        raise ValueError(f"zscan {zscan.shape} does not cover a {w}x{h} "
                         f"plane in 4x4 blocks")
    if not set(sizes) <= set(RANK_SIZES):
        raise ValueError(f"sizes {tuple(sizes)} not among {RANK_SIZES}")
    present = [n for n in sizes if h // n and w // n]
    if plane.device.type == "cpu":
        return rank_satd_tables_ref(plane, zscan, bd, strong, present)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    # the kernel's layout: the sizes' tables in ascending n
    order = sorted(set(present))
    counts = [(h // n) * (w // n) * 35 for n in order]
    flat = torch.empty(sum(counts), dtype=torch.int32, device=plane.device)
    key = (id(zscan), str(plane.device))
    z = _ZSCAN.get(key)
    if z is None:
        z = _ZSCAN[key] = torch.as_tensor(zscan.astype(np.int32),
                                          device=plane.device)
        weakref.finalize(zscan, _ZSCAN.pop, key, None)
    mask = sum(1 << RANK_SIZES.index(n) for n in order)
    if _RANK_LAUNCH is None:
        _RANK_LAUNCH = _launcher("rank_satd", "piipiiiipp")
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    with torch.cuda.device(plane.device):
        rc = _RANK_LAUNCH(plane.data_ptr(), w, h, z.data_ptr(), z.shape[1],
                          bd, int(bool(strong)), mask, flat.data_ptr(),
                          stream)
    if rc != 0:
        raise RuntimeError(f"rank_satd launch failed: CUDA error {rc}")
    rank_launches += len(order)
    tables = dict(zip(order, flat.split(counts)))
    return {n: tables[n].view(h // n, w // n, 35) for n in present}


def rank_satd_tables_device(plane, zscan, bd, strong, device,
                            sizes=RANK_SIZES):
    """Device twin of rank_satd_tables_host: {n: (hn, wn, 35) int32}
    numpy (from pinned memory on a card)."""
    p = upload(np.asarray(plane), resolve_device(device), torch.int16)
    tabs = rank_satd_tables(p, zscan, bd, strong, sizes)
    return dict(zip(tabs, _to_host(list(tabs.values()))))


def install_subpel_fields(enc) -> Optional[dict]:
    """Compute the subpel planes of each list's ref-0 plane on enc.device
    for native install; {(list, 0): (15, ph, pw) int16} or None."""
    if enc.sh.is_i:
        return None
    out = {}
    done = {}
    for lx in (0, 1):
        refs = enc.ref_lists[lx] if lx < len(enc.ref_lists) else []
        if not refs:
            continue
        plane = refs[0].planes[0]
        k = id(plane)
        if k not in done:
            done[k] = subpel_planes_device(np.asarray(plane),
                                           enc.sps.bit_depth_y, enc.device)
        out[(lx, 0)] = done[k]
    return out or None


class SeedFields(dict):
    """install_seed_fields' products: {list: (seed_mv, dense_mv, wb, hb,
    surf|None)}, with each list's (hb, wb) dense winner SADs in `sads`."""

    def __init__(self):
        super().__init__()
        self.sads = {}


def install_seed_fields(enc, orig) -> Optional[SeedFields]:
    """Run the encoder analysis (lowres pre-ME + dense full-pel ME field
    and its SAD surface) on enc.device against the encoder's list-0/1
    ref-0 planes; returns the fields for the native install, or None when
    the stage does not apply. The surface comes with the dense field
    unless TC_NO_ME_SURF is set, as on the host prepass; lists that share
    a plane share its fields."""
    global surfaces
    if enc.sh.is_i or enc.search_range < 16:
        return None
    want_surf = not os.environ.get("TC_NO_ME_SURF")
    fields = SeedFields()
    done = {}
    for lx in (0, 1):
        refs = enc.ref_lists[lx] if lx < len(enc.ref_lists) else []
        if not refs:
            continue
        plane = refs[0].planes[0]
        k = id(plane)
        if k not in done:
            sm, dm, ds, wb, hb, *rest = analysis_device(
                np.asarray(orig[0]), np.asarray(plane), enc.device,
                want_surf, enc.sps.bit_depth_y)
            if want_surf:
                surfaces += 1
            done[k] = (sm, dm, wb, hb, rest[0] if want_surf else None), ds
        fields[lx], fields.sads[lx] = done[k]
    return fields or None
