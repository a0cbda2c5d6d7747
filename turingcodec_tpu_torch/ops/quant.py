"""Batched (de)quantization (spec 8.6.3; havoc/quantize.cpp parity).

Shapes are (B, N, N) int32 levels with one QP per batch element, so one
call covers a mixed-QP batch. On the card the decoder does not call
`dequant_batch`: `ops/transform.dequant_idct_add` dequantizes every coded
TU of a picture inside the CUDA kernel `csrc/dequant_idct.cu`, with the
inverse transform and the add, and this function is the first step of
that kernel's plain version. `quant_batch` is the encoder side's HM
forward quantization, elementwise torch code on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from turingcodec_tpu_torch.hevc.tables import LEVEL_SCALE, QUANT_SCALES
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


def quant_batch(coeffs: torch.Tensor, qp: torch.Tensor, bit_depth: int,
                log2_size: int, rounding_num: torch.Tensor) -> torch.Tensor:
    """Forward quantization (HM-style): (B, N, N) transform coefficients +
    (B,) qp and (B,) additive rounding -> (B, N, N) int32 levels.

    level = sign(c) * min((|c| * f[qp % 6] + rounding) >> q_shift, 32767)
    with q_shift = 14 + qp // 6 + 15 - bit_depth - log2_size, a shift that
    differs per batch element. |c| <= 2^15 and f <= 26214 keep the product
    below 2^30, so the sum stays in int32 (rounding below 2^30)."""
    qp = qp.to(torch.int32)
    q_shift = (29 - bit_depth - log2_size
               + torch.div(qp, 6, rounding_mode="floor"))[:, None, None]
    f = table(QUANT_SCALES, coeffs.device)[(qp % 6).long()][:, None, None]
    c = coeffs.to(torch.int32)
    level = (c.abs() * f + rounding_num.to(torch.int32)[:, None, None]) \
        >> q_shift
    level = level.clamp(0, 32767)
    return torch.where(c < 0, -level, level)


def dequant_np(coeffs, qp, bit_depth, log2_size):
    """numpy oracle (flat scaling matrix)."""
    bd_shift = bit_depth + log2_size - 5
    ls = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    d = (coeffs.astype(np.int64) * ls * 16 + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)
