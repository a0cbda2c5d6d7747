"""Peaks of an H100 SXM at its 700 W limit, and the bound they give.

HBM3 at 3.35 TB/s (NVIDIA's data sheet). INT32 issue at 132 SMs x 64 lanes
x 1.98 GHz: worked out from the boost clock, not read from a data sheet,
so every share of a bound states it (chip_smoke.py, commit dd78b9c,
HBM_BYTES_PER_S, INT32_OPS_PER_S and bound)."""
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float):
    """(seconds, side): the larger of the bytes over the HBM rate and the
    INT32 operations over the INT32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
