"""HEVC core enumerations (ITU-T H.265 Table 7-1 and friends).

Parity reference: turing/HevcTypes.h:33 (NAL_UNIT_TYPES xmacro, slice types).
"""
from __future__ import annotations

import enum


class NalUnitType(enum.IntEnum):
    TRAIL_N = 0
    TRAIL_R = 1
    TSA_N = 2
    TSA_R = 3
    STSA_N = 4
    STSA_R = 5
    RADL_N = 6
    RADL_R = 7
    RASL_N = 8
    RASL_R = 9
    RSV_VCL_N10 = 10
    RSV_VCL_R11 = 11
    RSV_VCL_N12 = 12
    RSV_VCL_R13 = 13
    RSV_VCL_N14 = 14
    RSV_VCL_R15 = 15
    BLA_W_LP = 16
    BLA_W_RADL = 17
    BLA_N_LP = 18
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    RSV_IRAP_VCL22 = 22
    RSV_IRAP_VCL23 = 23
    RSV_VCL24 = 24
    RSV_VCL25 = 25
    RSV_VCL26 = 26
    RSV_VCL27 = 27
    RSV_VCL28 = 28
    RSV_VCL29 = 29
    RSV_VCL30 = 30
    RSV_VCL31 = 31
    VPS_NUT = 32
    SPS_NUT = 33
    PPS_NUT = 34
    AUD_NUT = 35
    EOS_NUT = 36
    EOB_NUT = 37
    FD_NUT = 38
    PREFIX_SEI_NUT = 39
    SUFFIX_SEI_NUT = 40


def is_vcl(nut: int) -> bool:
    return nut <= NalUnitType.RSV_VCL31


def is_irap(nut: int) -> bool:
    """IRAP: BLA/IDR/CRA and reserved IRAP types (spec 3.73)."""
    return NalUnitType.BLA_W_LP <= nut <= NalUnitType.RSV_IRAP_VCL23


def is_idr(nut: int) -> bool:
    return nut in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP)


def is_bla(nut: int) -> bool:
    return NalUnitType.BLA_W_LP <= nut <= NalUnitType.BLA_N_LP


def is_rasl(nut: int) -> bool:
    return nut in (NalUnitType.RASL_N, NalUnitType.RASL_R)


def is_radl(nut: int) -> bool:
    return nut in (NalUnitType.RADL_N, NalUnitType.RADL_R)


def is_sub_layer_non_reference(nut: int) -> bool:
    """Spec 7.4.2.2: *_N types are sub-layer non-reference pictures."""
    return nut in (
        NalUnitType.TRAIL_N, NalUnitType.TSA_N, NalUnitType.STSA_N,
        NalUnitType.RADL_N, NalUnitType.RASL_N,
        NalUnitType.RSV_VCL_N10, NalUnitType.RSV_VCL_N12,
        NalUnitType.RSV_VCL_N14,
    )


class SliceType(enum.IntEnum):
    B = 0
    P = 1
    I = 2


# Intra prediction modes (spec 8.4.2)
INTRA_PLANAR = 0
INTRA_DC = 1
INTRA_ANGULAR_2 = 2  # modes 2..34 are angular
INTRA_ANGULAR_10 = 10  # pure horizontal
INTRA_ANGULAR_26 = 26  # pure vertical

# Prediction modes (CuPredMode)
MODE_INTER = 0
MODE_INTRA = 1
MODE_SKIP = 2

# Partition modes (spec Table 7-10)
PART_2Nx2N = 0
PART_2NxN = 1
PART_Nx2N = 2
PART_NxN = 3
PART_2NxnU = 4
PART_2NxnD = 5
PART_nLx2N = 6
PART_nRx2N = 7
