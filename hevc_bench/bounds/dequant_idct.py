"""dequant_idct: chip_smoke.py::idct_ops and dequant_bound, commit dd78b9c,
with the port's TU table layout frozen (ops/transform.py: TU_KIND = 3,
kind = mode | log2 << 2 | comp << 5).

Per coded sample 2 bytes of level read, 2 of predicted sample read and 2
written, and the table's 16 bytes per TU; one dequantizing INT32 multiply
per sample and, for each inverse-DCT TU (mode 0), an n-point partial
butterfly per row and per column."""
import numpy as np

from hevc_bench.bounds.peaks import bound as _bound

KERNEL = "dequant_idct_add_kernel"
CALLS = (("turingcodec_tpu_torch.decode.device_pipeline", "dequant_idct_add"),
         ("turingcodec_tpu_torch.decode.device_recon", "dequant_idct_add"))
TU_KIND = 3


def idct_ops(n: int) -> int:
    return 4 if n == 2 else (n // 2) ** 2 + idct_ops(n // 2) + n


def bound(args, kwargs):
    table = np.asarray(args[2])
    kind = table[:, TU_KIND]
    log2, mode = (kind >> 2) & 7, kind & 3
    n = 1 << log2.astype(int)
    samples = int((n * n).sum())
    ops = samples + sum(2 * int(k) * idct_ops(int(k)) for k in n[mode == 0])
    return _bound(6 * samples + 16 * len(table), ops)
