"""HEVC constant tables as numpy arrays.

All values are ITU-T H.265 specification constants. Parity reference:
turing/ScanOrder.cpp (coefficient scans), turing/ScalingMatrices.h (default
scaling lists), turing/Global.h / Dsp.h (chroma QP table, filters).

Represented as dense numpy arrays so they can be fed straight into JAX/Pallas
kernels as gather tables.
"""
from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------- scans

@functools.lru_cache(maxsize=None)
def diag_scan_order(log2_size: int) -> np.ndarray:
    """Up-right diagonal scan (spec 6.5.3): array of (x, y), scan order index
    -> position. Size is 1 << log2_size square."""
    n = 1 << log2_size
    out = []
    # spec: process diagonals starting bottom-left going up-right
    i = 0
    x = y = 0
    stop = False
    while not stop:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
        if out and len(out) == n * n:
            stop = True
        if y >= 2 * n:
            stop = True
    return np.array(out[:n * n], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def horiz_scan_order(log2_size: int) -> np.ndarray:
    n = 1 << log2_size
    ys, xs = np.mgrid[0:n, 0:n]
    return np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def vert_scan_order(log2_size: int) -> np.ndarray:
    n = 1 << log2_size
    xs, ys = np.mgrid[0:n, 0:n]
    return np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.int32)


def scan_order(log2_size: int, scan_idx: int) -> np.ndarray:
    """scan_idx: 0=diag, 1=horizontal, 2=vertical (spec 6.5.3/7.4.9.11)."""
    if scan_idx == 0:
        return diag_scan_order(log2_size)
    if scan_idx == 1:
        return horiz_scan_order(log2_size)
    return vert_scan_order(log2_size)


# ---------------------------------------------------------------- scaling lists

# Spec Table 7-5: default 4x4 (flat 16) — intra and inter identical
_DEFAULT_4x4 = np.array([16] * 16, dtype=np.int32)

# Spec Table 7-6: default 8x8 intra, in up-right diagonal scan order
_DEFAULT_8x8_INTRA = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115,
], dtype=np.int32)

_DEFAULT_8x8_INTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91,
], dtype=np.int32)
# NOTE: the spec stores defaults in raster order of the 8x8 matrix; the
# scaling_list_data syntax transmits coefficients in diagonal scan order.
# The arrays above are the raster-order matrices (Table 7-6).


def default_scaling_list(size_id: int, matrix_id: int) -> np.ndarray:
    """Default ScalingList[sizeId][matrixId] in the *transmission* (diag scan)
    order used by scaling_list_data (spec 7.4.5)."""
    if size_id == 0:
        return _DEFAULT_4x4.copy()
    raster = _DEFAULT_8x8_INTRA if (matrix_id < 3 if size_id < 3 else matrix_id < 1) else _DEFAULT_8x8_INTER
    scan = diag_scan_order(3)
    out = raster.reshape(8, 8)[scan[:, 1], scan[:, 0]]
    return out.astype(np.int32)


# ---------------------------------------------------------------- quant

# Spec 8.6.3: levelScale[k] for quantization
LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)
# forward quant scale f[qp%6] (HM encoder constant; 2^14 / levelScale rounded)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)

# Spec Table 8-10: chroma QP mapping for ChromaArrayType==1, qPi 30..43
_CHROMA_QP_30_43 = np.array(
    [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37], dtype=np.int32)


def chroma_qp_from_luma(qp_i: int, chroma_format_idc: int = 1) -> int:
    """qPi -> QpC (spec 8.6.1, Table 8-10 applies only for 4:2:0)."""
    qp_i = int(qp_i)
    if chroma_format_idc != 1:
        return min(qp_i, 51)
    if qp_i < 30:
        return qp_i
    if qp_i > 43:
        return qp_i - 6
    return int(_CHROMA_QP_30_43[qp_i - 30])


# Vectorized form of the same mapping for qPi arrays (0..57)
CHROMA_QP_TABLE_420 = np.array(
    [chroma_qp_from_luma(q) for q in range(58)], dtype=np.int32)


# ---------------------------------------------------------------- transforms

# The 32 distinct magnitudes of the HEVC core transform (spec 8.6.4.2):
# c[k] = transMatrix32[k][0].  Every entry of every size-N matrix is
# +-c[fold(i * (2j+1) * 32/N)]: the matrix is a sampled integer cosine with
# the defining symmetry cos(pi*k/64), period 128, antisymmetric about k=32.
_DCT_C = np.array([
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0,
], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """HEVC core transform matrix (spec 8.6.4.2), n in {4, 8, 16, 32}.

    transMatrix_N[i][j] = transMatrix32[i * 32/N][j'] — built here from the
    32 canonical magnitudes via the cosine folding identity.
    """
    assert n in (4, 8, 16, 32)
    m = np.zeros((n, n), dtype=np.int64)
    step = 32 // n
    for i in range(n):
        ii = i * step
        for j in range(n):
            # angle = pi*k/64; cos period in k is 128
            k = (ii * (2 * j + 1)) % 128
            sign = 1
            if k > 64:
                k = 128 - k          # cos(2pi - t) = cos(t)
            if k > 32:
                k = 64 - k           # cos(pi - t) = -cos(t)
                sign = -1
            m[i, j] = sign * _DCT_C[k]
    return m

# DST-VII 4x4 matrix (spec 8.6.4.1)
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int64)


# ---------------------------------------------------------------- inter filters

# Spec Table 8-11: luma 8-tap interpolation filter coefficients per fraction
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Spec Table 8-12: chroma 4-tap filter per 1/8 fraction
CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


# ---------------------------------------------------------------- intra

# Spec Table 8-4: intraPredAngle per angular mode 2..34 (index 0 = mode 2)
INTRA_PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], dtype=np.int32)

# Spec Table 8-5: invAngle for modes 11..25 (index 0 = mode 11)
INTRA_INV_ANGLE = np.array([
    -4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482,
    -630, -910, -1638, -4096,
], dtype=np.int32)


def intra_pred_angle(mode: int) -> int:
    return int(INTRA_PRED_ANGLE[mode - 2])


def intra_inv_angle(mode: int) -> int:
    return int(INTRA_INV_ANGLE[mode - 11])


# residual_coding context maps -------------------------------------------

# Spec 9.3.4.2.5: ctxIdxMap for sig_coeff_flag of 4x4 TBs
SIG_CTX_4x4 = np.array([
    0, 1, 4, 5,
    2, 3, 4, 5,
    6, 6, 8, 8,
    7, 7, 8, 8,
], dtype=np.int32)


# A.4 general tier and level limits (reference turing/Levels.h:92-115):
# (units, tenths, tier, MaxLumaPs, MaxDpbSize, MaxCPB_kbit, MaxSliceSegs,
#  MaxTileRows, MaxTileCols, MaxLumaSr, MaxBR_kbit, MinCr)
LEVELS = [
    (1, 0, 0, 36864, 0, 350, 16, 1, 1, 552960, 128, 2),
    (2, 0, 0, 122880, 0, 1500, 16, 1, 1, 3686400, 1500, 2),
    (2, 1, 0, 245760, 0, 3000, 20, 1, 1, 7372800, 3000, 2),
    (3, 0, 0, 552960, 0, 6000, 30, 2, 2, 16588800, 6000, 2),
    (3, 1, 0, 983040, 0, 10000, 40, 3, 3, 33177600, 10000, 2),
    (4, 0, 0, 2228224, 0, 12000, 75, 5, 5, 66846720, 12000, 4),
    (4, 0, 1, 2228224, 0, 30000, 75, 5, 5, 66846720, 30000, 4),
    (4, 1, 0, 2228224, 0, 20000, 75, 5, 5, 133693440, 20000, 4),
    (4, 1, 1, 2228224, 0, 50000, 75, 5, 5, 133693440, 50000, 4),
    (5, 0, 0, 8912896, 0, 25000, 200, 11, 10, 267386880, 25000, 6),
    (5, 0, 1, 8912896, 0, 100000, 200, 11, 10, 267386880, 100000, 6),
    (5, 1, 0, 8912896, 0, 40000, 200, 11, 10, 534773760, 40000, 8),
    (5, 1, 1, 8912896, 0, 160000, 200, 11, 10, 534773760, 160000, 8),
    (5, 2, 0, 8912896, 0, 60000, 200, 11, 10, 1069547520, 60000, 8),
    (5, 2, 1, 8912896, 0, 240000, 200, 11, 10, 1069547520, 240000, 8),
    (6, 0, 0, 35651584, 0, 60000, 600, 22, 20, 1069547520, 60000, 8),
    (6, 0, 1, 35651584, 0, 240000, 600, 22, 20, 1069547520, 240000, 8),
    (6, 1, 0, 35651584, 0, 120000, 600, 22, 20, 2139095040, 120000, 8),
    (6, 1, 1, 35651584, 0, 480000, 600, 22, 20, 2139095040, 480000, 8),
    (6, 2, 0, 35651584, 0, 240000, 600, 22, 20, 4278190080, 240000, 6),
    (6, 2, 1, 35651584, 0, 800000, 600, 22, 20, 4278190080, 800000, 6),
]


def derive_level(pic_size_in_samples_y: int, frame_rate: float):
    """Smallest Main-tier level fitting the picture size and sample rate
    (Encoder::setupPtl, reference Encoder.cpp:590-606). Returns
    (general_level_idc, max_cpb_bits) — level_idc = 30*units + 3*tenths —
    or (0, 0) when nothing fits (level signalled as unknown)."""
    for (units, tenths, tier, max_ps, _dpb, max_cpb_k, _slices, _tr, _tc,
         max_sr, _br, _cr) in LEVELS:
        if tier:
            continue  # reference picks Main tier rows (break on first fit)
        if max_ps >= pic_size_in_samples_y \
                and max_sr >= pic_size_in_samples_y * frame_rate:
            return 30 * units + 3 * tenths, max_cpb_k * 1000
    return 0, 0
