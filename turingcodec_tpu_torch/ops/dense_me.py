"""Dense full-pel motion-estimation sweep: the encoder analysis stage's
one hand-written kernel.

`dense_me_argmin` replaces the Pallas TPU kernel
`turingcodec_tpu/ops/pallas_kernels.py::dense_me_argmin` with the CUDA
kernel in `csrc/dense_me.cu` (its header states the design and what bounds
it on an H100). `dense_me_argmin_ref` is the plain torch version of the
same function: the wrapper takes it for CPU tensors, and the kernel is held
against it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from turingcodec_tpu_torch.ops import kernel_build

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_LAUNCH = None


def _check(cur: torch.Tensor, patches: torch.Tensor) -> int:
    if cur.device != patches.device:
        raise ValueError(f"cur on {cur.device}, patches on {patches.device}")
    if cur.dtype != torch.int32 or patches.dtype != torch.int32:
        raise TypeError(f"int32 inputs required, got {cur.dtype}, "
                        f"{patches.dtype}")
    b = cur.shape[0]
    if cur.shape != (b, 16, 16) or patches.shape != (b, 32, 32):
        raise ValueError(f"shapes (B,16,16) and (B,32,32) required, got "
                         f"{tuple(cur.shape)} and {tuple(patches.shape)}")
    if not (cur.is_contiguous() and patches.is_contiguous()):
        raise ValueError("contiguous inputs required")
    return b


def dense_me_argmin_ref(cur: torch.Tensor,
                        patches: torch.Tensor) -> torch.Tensor:
    """Plain torch version: all 289 window SADs, then the min of the packed
    key (cost << 9) | k with k = oy * 17 + ox, whose ties resolve to the
    first offset in (oy, ox) scan order."""
    b = _check(cur, patches)
    win = patches.unfold(1, 16, 1).unfold(2, 16, 1)   # (B, 17, 17, 16, 16)
    c = cur[:, None]
    # one window row at a time keeps the (B, 17, 16, 16) difference small
    sad = torch.stack([(c - win[:, oy]).abs().sum((-2, -1))
                       for oy in range(17)], 1).reshape(b, 289)
    a = torch.arange(17, device=cur.device) - 8
    pen = (a[:, None].abs() + a[None, :].abs()).reshape(289)
    k = torch.arange(289, device=cur.device)
    key = (((sad << 2) + pen) << 9) | k
    kbest = key.min(1).values & 511
    return torch.stack([kbest % 17 - 8, kbest // 17 - 8,
                        sad.gather(1, kbest[:, None])[:, 0]],
                       1).to(torch.int32)


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load("dense_me").dense_me_argmin_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        _LAUNCH = fn
    return _LAUNCH


def dense_me_argmin(cur: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """For each block, the (ox, oy) in [-8, 8]^2 minimising
    (SAD(cur, patches[oy+8:oy+24, ox+8:ox+24]) << 2) + |ox| + |oy|, ties to
    the first offset in (oy, ox) scan order.

    cur: (B, 16, 16) int32 source blocks; patches: (B, 32, 32) int32
    reference windows at seed - 8; samples of at most 12 bits. Returns
    (B, 3) int32 [ox, oy, sad]. CPU tensors take the plain version; CUDA
    tensors launch the kernel, and a failed build or launch raises."""
    global launches
    b = _check(cur, patches)
    if cur.device.type == "cpu":
        return dense_me_argmin_ref(cur, patches)
    if cur.device.type != "cuda":
        raise ValueError(f"unsupported device {cur.device}")
    out = torch.empty((b, 3), dtype=torch.int32, device=cur.device)
    if b == 0:
        return out
    fn = _launcher()
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    with torch.cuda.device(cur.device):
        rc = fn(cur.data_ptr(), patches.data_ptr(), out.data_ptr(), b,
                stream)
    if rc != 0:
        raise RuntimeError(f"dense_me_argmin launch failed: CUDA error {rc}")
    launches += 1
    return out
