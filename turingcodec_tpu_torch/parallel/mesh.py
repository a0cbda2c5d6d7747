"""The codec's batched pixel pipeline over a (frame, row) grid: the port of
`turingcodec_tpu/parallel/mesh.py`.

The reference scales with WPP threads and concurrent frames (SURVEY.md
section 2.7); the JAX package shards (frames, CTU rows) over a 2-D mesh of
chips. On one card every cell of the grid is that card, and the "frame"
and "row" axes become batch dimensions of one launch per stage: the
totals are plain reductions on the card, with no collective. Spreading
the cells over several cards waits for hardware that can test it
(ROADMAP.md); make_mesh refuses a grid over more than one device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from turingcodec_tpu_torch.encode.device_analysis import resolve_device
from turingcodec_tpu_torch.ops.quant import quant_batch
from turingcodec_tpu_torch.ops.transform import forward_transform_batch

AXES = ("frame", "row")
ROUNDING = 171 << 6      # the analysis step's quantisation rounding


@dataclass(frozen=True)
class Mesh:
    """A (frame, row) grid of torch devices: `devices` is the (F, R) object
    array of its cells, all one device (`device`)."""
    devices: np.ndarray

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def device(self) -> torch.device:
        return self.devices.flat[0]


def make_mesh(n_frames: int, n_rows: int, devices=None) -> Mesh:
    """An n_frames x n_rows grid. devices: one device, or a sequence whose
    first n_frames * n_rows entries are the cells (all the same device);
    None is the card ("cuda", which raises without one)."""
    if n_frames < 1 or n_rows < 1:
        raise ValueError(f"a {n_frames}x{n_rows} mesh has no cells")
    if devices is None or isinstance(devices, (str, torch.device)):
        cells = [devices or "cuda"] * (n_frames * n_rows)
    else:
        cells = list(devices)[:n_frames * n_rows]
        if len(cells) == 1:
            cells *= n_frames * n_rows
        if len(cells) < n_frames * n_rows:
            raise ValueError(f"{len(cells)} devices for a {n_frames}x"
                             f"{n_rows} mesh")
    cells = [resolve_device(d) for d in cells]
    if None in cells or len(set(cells)) != 1:
        raise ValueError(f"the cells {sorted(set(map(str, cells)))} are not "
                         f"one torch device: a mesh over several devices is "
                         f"not supported")
    grid = np.empty(n_frames * n_rows, object)
    grid[:] = cells
    return Mesh(grid.reshape(n_frames, n_rows))


def analysis_step(ctus: torch.Tensor, preds: torch.Tensor, qp):
    """One batched encoder analysis step over (F, R, B, 32, 32) int32
    source blocks and predictions: residual -> forward DCT (the
    fwd_transform kernel on the card) -> quantisation (rounding 171 << 6)
    -> per-block rate proxy (nonzero levels plus the sum of |level|) and
    distortion (the sum of squared coefficients that quantise to 0).

    Returns rate (F, R, B) int32, dist (F, R, B) int64 and the two totals
    (int64 scalars). The distortion is exact: the JAX program sums float32
    squares and casts them to int32, which agrees wherever every partial
    sum is an integer below 2^24 (ROADMAP.md, queue 3)."""
    if ctus.shape != preds.shape or ctus.dim() != 5 \
            or tuple(ctus.shape[3:]) != (32, 32):
        raise ValueError(f"(F, R, B, 32, 32) blocks required, got "
                         f"{tuple(ctus.shape)} and {tuple(preds.shape)}")
    f, r, b, n, _ = ctus.shape
    res = (ctus.to(torch.int32) - preds.to(torch.int32)).reshape(
        f * r * b, n, n).contiguous()
    coeffs = forward_transform_batch(res, 8, False)
    qps = torch.as_tensor(qp, dtype=torch.int32,
                          device=ctus.device).reshape(()).expand(f * r * b)
    rounding = torch.full((f * r * b,), ROUNDING, dtype=torch.int32,
                          device=ctus.device)
    levels = quant_batch(coeffs, qps, 8, 5, rounding)
    rate = ((levels != 0).sum((1, 2), dtype=torch.int32)
            + levels.abs().sum((1, 2), dtype=torch.int32))
    c64 = coeffs.to(torch.int64)
    dist = torch.where(levels == 0, c64 * c64, 0).sum((1, 2))
    rate = rate.reshape(f, r, b)
    dist = dist.reshape(f, r, b)
    return rate, dist, rate.sum(dtype=torch.int64), dist.sum()


def sharded_analysis(mesh: Mesh):
    """analysis_step over the mesh's grid: the inputs (and a tensor qp) go
    to the mesh's device, and one call covers every cell."""
    dev = mesh.device

    def fn(ctus, preds, qp):
        if ctus.shape[:2] != tuple(mesh.devices.shape):
            raise ValueError(f"blocks {tuple(ctus.shape[:2])} for a "
                             f"{tuple(mesh.devices.shape)} mesh")
        qp = qp.to(dev) if isinstance(qp, torch.Tensor) else qp
        return analysis_step(ctus.to(dev), preds.to(dev), qp)
    return fn
