"""CABAC spec tables (ITU-T H.265 clause 9.3).

All numbers are HEVC specification constants (Tables 9-40..9-46 and the
per-element initValue tables 9-5..9-32). Parity reference for layout:
turing/Cabac.cpp:26-251, turing/ContextModel.h:31-121, turing/Cabac.h:460.

Context-state representation: pStateIdx (0..63) and valMps (0/1) kept as a
single uint8 ``2*pStateIdx + valMps`` so MPS/LPS transitions are single table
lookups — convenient both for the host engine and for future vectorized
(batched-row) engines.
"""
from __future__ import annotations

import numpy as np

# Table 9-46: rangeTabLPS[pStateIdx][(ivlCurrRange >> 6) & 3]
RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.uint8)

# Table 9-41: state transition after decoding an LPS
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.uint8)

# Table 9-41: state transition after decoding an MPS
TRANS_IDX_MPS = np.minimum(np.arange(64) + 1, 62).astype(np.uint8)
TRANS_IDX_MPS[63] = 63

# Packed transition tables on state = 2*pStateIdx + valMps.
# After MPS: pStateIdx advances, valMps unchanged; pState 62/63 saturate.
# After LPS: if pStateIdx == 0 valMps flips; pStateIdx -> TRANS_IDX_LPS.
_s = np.arange(128)
_p, _m = _s >> 1, _s & 1
NEXT_STATE_MPS = (2 * TRANS_IDX_MPS[_p] + _m).astype(np.uint8)
_flip = (_p == 0)
NEXT_STATE_LPS = (2 * TRANS_IDX_LPS[_p] + np.where(_flip, 1 - _m, _m)).astype(np.uint8)


def init_state(init_value: int, slice_qp_y: int) -> int:
    """Spec 9.3.2.2 context-variable initialization -> packed state."""
    m = (init_value >> 4) * 5 - 45
    n = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((m * min(max(0, slice_qp_y), 51)) >> 4) + n), 126)
    if pre >= 64:
        return 2 * (pre - 64) + 1  # valMps = 1
    return 2 * (63 - pre)          # valMps = 0


# --- Per-element initValue tables (spec 9.3.2.2 Tables 9-5..9-32) ---------
# For each element: list of three lists [initType0, initType1, initType2].
# initType: 0 for I slices; P/B slices use 1/2 per cabac_init_flag
# (spec Table 9-4). Elements absent in I slices have empty initType-0 lists.

INIT_VALUES = {
    "sao_merge_flag": [[153], [153], [153]],
    "sao_type_idx": [[200], [185], [160]],
    "split_cu_flag": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "cu_transquant_bypass_flag": [[154], [154], [154]],
    "cu_skip_flag": [[], [197, 185, 201], [197, 185, 201]],
    "cu_qp_delta_abs": [[154, 154], [154, 154], [154, 154]],
    "cu_chroma_qp_offset_flag": [[154], [154], [154]],
    "cu_chroma_qp_offset_idx": [[154], [154], [154]],
    "pred_mode_flag": [[], [149], [134]],
    "part_mode": [[184], [154, 139, 154, 154], [154, 139, 154, 154]],
    "prev_intra_luma_pred_flag": [[184], [154], [183]],
    "intra_chroma_pred_mode": [[63], [152], [152]],
    "merge_flag": [[], [110], [154]],
    "merge_idx": [[], [122], [137]],
    "inter_pred_idc": [[], [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]],
    "ref_idx": [[], [153, 153], [153, 153]],
    "abs_mvd_greater0_flag": [[], [140], [169]],
    "abs_mvd_greater1_flag": [[], [198], [198]],
    "mvp_flag": [[], [168], [168]],
    "rqt_root_cbf": [[], [79], [79]],
    "split_transform_flag": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    "cbf_luma": [[111, 141], [153, 111], [153, 111]],
    "cbf_chroma": [[94, 138, 182, 154], [149, 107, 167, 154], [149, 92, 167, 154]],
    "transform_skip_flag_luma": [[139], [139], [139]],
    "transform_skip_flag_chroma": [[139], [139], [139]],
    "last_sig_coeff_x_prefix": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93]],
    "last_sig_coeff_y_prefix": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
         79, 108, 123, 63],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93]],
    "coded_sub_block_flag": [[91, 171, 134, 141], [121, 140, 61, 154],
                             [121, 140, 61, 154]],
    "sig_coeff_flag": [
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
         139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111,
         141, 111],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140,
         140, 140],
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170,
         153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140,
         140, 140]],
    "coeff_abs_level_greater1_flag": [
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182]],
    "coeff_abs_level_greater2_flag": [
        [138, 153, 136, 167, 152, 152], [107, 167, 91, 122, 107, 167],
        [107, 167, 91, 107, 107, 167]],
    "explicit_rdpcm_flag": [[], [139, 139], [139, 139]],
    "explicit_rdpcm_dir_flag": [[], [139, 139], [139, 139]],
    "log2_res_scale_abs_plus1": [[154] * 8, [154] * 8, [154] * 8],
    "res_scale_sign_flag": [[154, 154], [154, 154], [154, 154]],
}

# Fixed ordering of context blocks; offsets computed once.
CONTEXT_ELEMENTS = list(INIT_VALUES.keys())
_sizes = {k: max(len(v[0]), len(v[1]), len(v[2])) for k, v in INIT_VALUES.items()}
CONTEXT_OFFSET = {}
_off = 0
for _k in CONTEXT_ELEMENTS:
    CONTEXT_OFFSET[_k] = _off
    _off += _sizes[_k]
NUM_CONTEXTS = _off


def make_init_table() -> np.ndarray:
    """(3 initTypes, 52 QPs, NUM_CONTEXTS) packed initial states."""
    table = np.full((3, 52, NUM_CONTEXTS), 2 * (63 - 1), dtype=np.uint8)
    for k, lists in INIT_VALUES.items():
        off = CONTEXT_OFFSET[k]
        for it in range(3):
            for i, iv in enumerate(lists[it]):
                for qp in range(52):
                    table[it, qp, off + i] = init_state(iv, qp)
    return table


INIT_TABLE = make_init_table()
