"""Batched dequantization (spec 8.6.3; havoc/quantize.cpp parity).

Shapes are (B, N, N) int32 levels with one QP per batch element, so one
call covers a mixed-QP batch. On the card the decoder does not call
`dequant_batch`: `ops/transform.dequant_idct_add` dequantizes every coded
TU of a picture inside the CUDA kernel `csrc/dequant_idct.cu`, with the
inverse transform and the add, and this function is the first step of
that kernel's plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from turingcodec_tpu_torch.hevc.tables import LEVEL_SCALE
from turingcodec_tpu_torch.ops.kernel_build import table


def dequant_batch(coeffs: torch.Tensor, qp: torch.Tensor, bit_depth: int,
                  log2_size: int) -> torch.Tensor:
    """(B, N, N) levels + (B,) qp -> (B, N, N) int32 dequantized (flat list).

    int32-exact: qp // 6 folds into the shift instead of the scale, which
    is the oracle's int64 form because the rounding constant scales with
    the shift. |level| <= 32768 and qp <= 63 keep every product below 2^31.
    """
    bd_shift = bit_depth + log2_size - 5
    qp = qp.to(torch.int32)
    ls16 = table(LEVEL_SCALE, coeffs.device)[(qp % 6).long()] * 16  # <= 1152
    shift = bd_shift - torch.div(qp, 6, rounding_mode="floor")
    sh_pos = shift.clamp(min=0)[:, None, None]
    sh_neg = (-shift).clamp(min=0)[:, None, None]
    rnd = torch.where(shift > 0,
                      torch.ones_like(shift) << (shift - 1).clamp(min=0),
                      torch.zeros_like(shift))
    p = coeffs.to(torch.int32) * ls16[:, None, None]
    d = ((p + rnd[:, None, None]) >> sh_pos) << sh_neg
    return d.clamp(-32768, 32767).to(torch.int32)


def dequant_np(coeffs, qp, bit_depth, log2_size):
    """numpy oracle (flat scaling matrix)."""
    bd_shift = bit_depth + log2_size - 5
    ls = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    d = (coeffs.astype(np.int64) * ls * 16 + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)
