"""Parse/write functions for HEVC header syntax (RBSP level).

Single source of syntax order for both directions — each parse_x has a
mirror write_x walking fields identically. Parity reference:
turing/SyntaxRbsp.hpp (read/write via verb templates).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from turingcodec_tpu_torch.bitstream.reader import BitReader
from turingcodec_tpu_torch.decode.violations import Violation, check_range
from turingcodec_tpu_torch.bitstream.writer import BitWriter
from turingcodec_tpu_torch.hevc import types as T
from turingcodec_tpu_torch.hevc.params import (
    HrdParameters,
    ParamSets,
    Pps,
    ProfileTierLevel,
    ScalingListData,
    ShortTermRefPicSet,
    SliceSegmentHeader,
    Sps,
    VuiParameters,
    Vps,
)


# ---------------------------------------------------------------- PTL

def parse_ptl(br: BitReader, max_sub_layers_minus1: int) -> ProfileTierLevel:
    p = ProfileTierLevel()
    p.general_profile_space = br.u(2)
    p.general_tier_flag = br.u(1)
    p.general_profile_idc = br.u(5)
    p.general_profile_compatibility_flags = br.u(32)
    p.general_progressive_source_flag = br.u(1)
    p.general_interlaced_source_flag = br.u(1)
    p.general_non_packed_constraint_flag = br.u(1)
    p.general_frame_only_constraint_flag = br.u(1)
    p.general_reserved_44bits = br.u(44)
    p.general_level_idc = br.u(8)
    p.sub_layer_profile_present = []
    p.sub_layer_level_present = []
    for _ in range(max_sub_layers_minus1):
        p.sub_layer_profile_present.append(br.u(1))
        p.sub_layer_level_present.append(br.u(1))
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            br.u(2)  # reserved_zero_2bits
    p.sub_layer_raw = []
    for i in range(max_sub_layers_minus1):
        prof = br.u(88) if p.sub_layer_profile_present[i] else None
        lvl = br.u(8) if p.sub_layer_level_present[i] else None
        p.sub_layer_raw.append((prof, lvl))
    return p


def write_ptl(bw: BitWriter, p: ProfileTierLevel, max_sub_layers_minus1: int):
    bw.u(p.general_profile_space, 2)
    bw.u(p.general_tier_flag, 1)
    bw.u(p.general_profile_idc, 5)
    bw.u(p.general_profile_compatibility_flags, 32)
    bw.u(p.general_progressive_source_flag, 1)
    bw.u(p.general_interlaced_source_flag, 1)
    bw.u(p.general_non_packed_constraint_flag, 1)
    bw.u(p.general_frame_only_constraint_flag, 1)
    bw.u(p.general_reserved_44bits, 44)
    bw.u(p.general_level_idc, 8)
    for i in range(max_sub_layers_minus1):
        bw.u(p.sub_layer_profile_present[i], 1)
        bw.u(p.sub_layer_level_present[i], 1)
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            bw.u(0, 2)
    for i in range(max_sub_layers_minus1):
        prof, lvl = p.sub_layer_raw[i]
        if p.sub_layer_profile_present[i]:
            bw.u(prof, 88)
        if p.sub_layer_level_present[i]:
            bw.u(lvl, 8)


# ---------------------------------------------------------------- RPS

def parse_st_ref_pic_set(br: BitReader, idx: int, num_sets: int,
                         prev_sets: List[ShortTermRefPicSet]) -> ShortTermRefPicSet:
    """st_ref_pic_set() with inter-RPS prediction expanded (spec 7.4.8)."""
    rps = ShortTermRefPicSet()
    inter_pred = br.u(1) if idx != 0 else 0
    if inter_pred:
        delta_idx_minus1 = br.ue() if idx == num_sets else 0
        ref_rps_idx = idx - (delta_idx_minus1 + 1)
        delta_rps_sign = br.u(1)
        abs_delta_rps_minus1 = check_range(
            "7.4.8", "abs_delta_rps_minus1", br.ue(), 0, (1 << 15) - 1)
        check_range("7.4.8", "delta_idx_minus1 (ref_rps_idx)",
                    ref_rps_idx, 0, max(0, idx - 1))
        delta_rps = (1 - 2 * delta_rps_sign) * (abs_delta_rps_minus1 + 1)
        ref = prev_sets[ref_rps_idx]
        n_ref = ref.num_delta_pocs
        used, use_delta = [], []
        for j in range(n_ref + 1):
            u = br.u(1)
            used.append(u)
            use_delta.append(br.u(1) if not u else 1)
        # derivation 7.4.8 (7-47..7-50): ref delta pocs in order s0 then s1
        ref_d = list(ref.delta_poc_s0) + list(ref.delta_poc_s1)
        s0, u0, s1, u1 = [], [], [], []
        # negative part: iterate ref S1 descending, then deltaRps, then ref S0
        for j in range(ref.num_positive_pics - 1, -1, -1):
            d_poc = ref.delta_poc_s1[j] + delta_rps
            if d_poc < 0 and use_delta[ref.num_negative_pics + j]:
                s0.append(d_poc)
                u0.append(used[ref.num_negative_pics + j])
        if delta_rps < 0 and use_delta[n_ref]:
            s0.append(delta_rps)
            u0.append(used[n_ref])
        for j in range(ref.num_negative_pics):
            d_poc = ref.delta_poc_s0[j] + delta_rps
            if d_poc < 0 and use_delta[j]:
                s0.append(d_poc)
                u0.append(used[j])
        # positive part: ref S0 descending, deltaRps, ref S1
        for j in range(ref.num_negative_pics - 1, -1, -1):
            d_poc = ref.delta_poc_s0[j] + delta_rps
            if d_poc > 0 and use_delta[j]:
                s1.append(d_poc)
                u1.append(used[j])
        if delta_rps > 0 and use_delta[n_ref]:
            s1.append(delta_rps)
            u1.append(used[n_ref])
        for j in range(ref.num_positive_pics):
            d_poc = ref.delta_poc_s1[j] + delta_rps
            if d_poc > 0 and use_delta[ref.num_negative_pics + j]:
                s1.append(d_poc)
                u1.append(used[ref.num_negative_pics + j])
        rps.delta_poc_s0, rps.used_s0 = s0, u0
        rps.delta_poc_s1, rps.used_s1 = s1, u1
    else:
        num_neg = check_range("7.4.8", "num_negative_pics", br.ue(), 0, 16)
        num_pos = check_range("7.4.8", "num_positive_pics", br.ue(), 0, 16)
        d = 0
        for _ in range(num_neg):
            d -= check_range("7.4.8", "delta_poc_s0_minus1", br.ue(), 0,
                             (1 << 15) - 1) + 1
            rps.delta_poc_s0.append(d)
            rps.used_s0.append(br.u(1))
        d = 0
        for _ in range(num_pos):
            d += check_range("7.4.8", "delta_poc_s1_minus1", br.ue(), 0,
                             (1 << 15) - 1) + 1
            rps.delta_poc_s1.append(d)
            rps.used_s1.append(br.u(1))
    return rps


def write_st_ref_pic_set(bw: BitWriter, rps: ShortTermRefPicSet, idx: int):
    """Always writes the explicit (non-inter-predicted) form."""
    if idx != 0:
        bw.u(0, 1)  # inter_ref_pic_set_prediction_flag
    bw.ue(rps.num_negative_pics)
    bw.ue(rps.num_positive_pics)
    prev = 0
    for d, u in zip(rps.delta_poc_s0, rps.used_s0):
        bw.ue(prev - d - 1)
        prev = d
        bw.u(u, 1)
    prev = 0
    for d, u in zip(rps.delta_poc_s1, rps.used_s1):
        bw.ue(d - prev - 1)
        prev = d
        bw.u(u, 1)


# ---------------------------------------------------------------- scaling lists

def parse_scaling_list_data(br: BitReader) -> ScalingListData:
    sld = ScalingListData()
    sld.lists = [[None] * 6 for _ in range(4)]
    sld.dc = [[8] * 6 for _ in range(2)]
    from turingcodec_tpu_torch.hevc.tables import default_scaling_list, diag_scan_order
    for size_id in range(4):
        matrix_id = 0
        while matrix_id < 6:
            pred_mode = br.u(1)
            coef_num = min(64, 1 << (4 + (size_id << 1)))
            if not pred_mode:
                delta = br.ue()
                if delta == 0:
                    sld.lists[size_id][matrix_id] = default_scaling_list(size_id, matrix_id).copy()
                else:
                    ref_id = matrix_id - delta * (3 if size_id == 3 else 1)
                    check_range("7.4.5", "scaling_list_pred_matrix_id_delta"
                                " (ref)", ref_id, 0, max(0, matrix_id - 1))
                    sld.lists[size_id][matrix_id] = sld.lists[size_id][ref_id].copy()
                    if size_id > 1:
                        sld.dc[size_id - 2][matrix_id] = sld.dc[size_id - 2][ref_id]
            else:
                next_coef = 8
                if size_id > 1:
                    dc = check_range("7.4.5", "scaling_list_dc_coef_minus8",
                                     br.se(), -7, 247) + 8
                    sld.dc[size_id - 2][matrix_id] = dc
                    next_coef = dc
                coefs = np.zeros(coef_num, dtype=np.int32)
                for i in range(coef_num):
                    next_coef = (next_coef + br.se() + 256) % 256
                    coefs[i] = next_coef
                sld.lists[size_id][matrix_id] = coefs
            matrix_id += 3 if size_id == 3 else 1
    return sld


# ---------------------------------------------------------------- HRD / VUI

def parse_sub_layer_hrd(br: BitReader, cpb_cnt: int, sub_pic: int) -> list:
    out = []
    for _ in range(cpb_cnt):
        e = {"bit_rate_value_minus1": br.ue(), "cpb_size_value_minus1": br.ue()}
        if sub_pic:
            e["cpb_size_du_value_minus1"] = br.ue()
            e["bit_rate_du_value_minus1"] = br.ue()
        e["cbr_flag"] = br.u(1)
        out.append(e)
    return out


def parse_hrd(br: BitReader, common_inf: int, max_sub_layers_minus1: int) -> HrdParameters:
    h = HrdParameters()
    if common_inf:
        h.nal_hrd_parameters_present_flag = br.u(1)
        h.vcl_hrd_parameters_present_flag = br.u(1)
        if h.nal_hrd_parameters_present_flag or h.vcl_hrd_parameters_present_flag:
            h.sub_pic_hrd_params_present_flag = br.u(1)
            if h.sub_pic_hrd_params_present_flag:
                h.tick_divisor_minus2 = br.u(8)
                h.du_cpb_removal_delay_increment_length_minus1 = br.u(5)
                h.sub_pic_cpb_params_in_pic_timing_sei_flag = br.u(1)
                h.dpb_output_delay_du_length_minus1 = br.u(5)
            h.bit_rate_scale = br.u(4)
            h.cpb_size_scale = br.u(4)
            if h.sub_pic_hrd_params_present_flag:
                h.cpb_size_du_scale = br.u(4)
            h.initial_cpb_removal_delay_length_minus1 = br.u(5)
            h.au_cpb_removal_delay_length_minus1 = br.u(5)
            h.dpb_output_delay_length_minus1 = br.u(5)
    for _ in range(max_sub_layers_minus1 + 1):
        sl = {}
        sl["fixed_pic_rate_general_flag"] = br.u(1)
        sl["fixed_pic_rate_within_cvs_flag"] = (
            sl["fixed_pic_rate_general_flag"] or br.u(1))
        sl["low_delay_hrd_flag"] = 0
        sl["cpb_cnt_minus1"] = 0
        if sl["fixed_pic_rate_within_cvs_flag"]:
            sl["elemental_duration_in_tc_minus1"] = br.ue()
        else:
            sl["low_delay_hrd_flag"] = br.u(1)
        if not sl["low_delay_hrd_flag"]:
            sl["cpb_cnt_minus1"] = br.ue()
        cpb_cnt = sl["cpb_cnt_minus1"] + 1
        if h.nal_hrd_parameters_present_flag:
            sl["nal_hrd"] = parse_sub_layer_hrd(br, cpb_cnt, h.sub_pic_hrd_params_present_flag)
        if h.vcl_hrd_parameters_present_flag:
            sl["vcl_hrd"] = parse_sub_layer_hrd(br, cpb_cnt, h.sub_pic_hrd_params_present_flag)
        h.sub_layers.append(sl)
    return h


def parse_vui(br: BitReader, sps: Sps) -> VuiParameters:
    v = VuiParameters()
    if br.u(1):  # aspect_ratio_info_present
        v.aspect_ratio_idc = br.u(8)
        if v.aspect_ratio_idc == 255:
            v.sar_width = br.u(16)
            v.sar_height = br.u(16)
    if br.u(1):  # overscan_info_present
        v.overscan_appropriate_flag = br.u(1)
    if br.u(1):  # video_signal_type_present
        v.video_format = br.u(3)
        v.video_full_range_flag = br.u(1)
        if br.u(1):  # colour_description_present
            v.colour_primaries = br.u(8)
            v.transfer_characteristics = br.u(8)
            v.matrix_coeffs = br.u(8)
    if br.u(1):  # chroma_loc_info_present
        v.chroma_sample_loc_type_top_field = br.ue()
        v.chroma_sample_loc_type_bottom_field = br.ue()
    v.neutral_chroma_indication_flag = br.u(1)
    v.field_seq_flag = br.u(1)
    v.frame_field_info_present_flag = br.u(1)
    if br.u(1):  # default_display_window
        v.default_display_window = (br.ue(), br.ue(), br.ue(), br.ue())
    if br.u(1):  # vui_timing_info_present
        v.timing_info = (br.u(32), br.u(32))
        v.poc_proportional_to_timing_flag = br.u(1)
        if v.poc_proportional_to_timing_flag:
            v.num_ticks_poc_diff_one_minus1 = br.ue()
        if br.u(1):  # vui_hrd_parameters_present
            v.hrd = parse_hrd(br, 1, sps.sps_max_sub_layers_minus1)
    if br.u(1):  # bitstream_restriction
        v.bitstream_restriction = {
            "tiles_fixed_structure_flag": br.u(1),
            "motion_vectors_over_pic_boundaries_flag": br.u(1),
            "restricted_ref_pic_lists_flag": br.u(1),
            "min_spatial_segmentation_idc": br.ue(),
            "max_bytes_per_pic_denom": br.ue(),
            "max_bits_per_min_cu_denom": br.ue(),
            "log2_max_mv_length_horizontal": br.ue(),
            "log2_max_mv_length_vertical": br.ue(),
        }
    return v


# ---------------------------------------------------------------- VPS / SPS / PPS

def parse_vps(br: BitReader) -> Vps:
    v = Vps()
    v.vps_video_parameter_set_id = br.u(4)
    v.vps_base_layer_internal_flag = br.u(1)
    v.vps_base_layer_available_flag = br.u(1)
    v.vps_max_layers_minus1 = br.u(6)
    v.vps_max_sub_layers_minus1 = br.u(3)
    v.vps_temporal_id_nesting_flag = br.u(1)
    br.u(16)  # vps_reserved_0xffff_16bits
    v.ptl = parse_ptl(br, v.vps_max_sub_layers_minus1)
    v.vps_sub_layer_ordering_info_present_flag = br.u(1)
    v.vps_max_dec_pic_buffering_minus1 = []
    v.vps_max_num_reorder_pics = []
    v.vps_max_latency_increase_plus1 = []
    start = 0 if v.vps_sub_layer_ordering_info_present_flag else v.vps_max_sub_layers_minus1
    for _ in range(start, v.vps_max_sub_layers_minus1 + 1):
        v.vps_max_dec_pic_buffering_minus1.append(br.ue())
        v.vps_max_num_reorder_pics.append(br.ue())
        v.vps_max_latency_increase_plus1.append(br.ue())
    v.vps_max_layer_id = br.u(6)
    v.vps_num_layer_sets_minus1 = br.ue()
    for _ in range(1, v.vps_num_layer_sets_minus1 + 1):
        for _ in range(v.vps_max_layer_id + 1):
            br.u(1)  # layer_id_included_flag
    v.vps_timing_info_present_flag = br.u(1)
    if v.vps_timing_info_present_flag:
        v.vps_num_units_in_tick = br.u(32)
        v.vps_time_scale = br.u(32)
        v.vps_poc_proportional_to_timing_flag = br.u(1)
        if v.vps_poc_proportional_to_timing_flag:
            v.vps_num_ticks_poc_diff_one_minus1 = br.ue()
        vps_num_hrd_parameters = br.ue()
        for i in range(vps_num_hrd_parameters):
            br.ue()  # hrd_layer_set_idx
            cprms = br.u(1) if i > 0 else 1
            parse_hrd(br, cprms, v.vps_max_sub_layers_minus1)
    if br.u(1):  # vps_extension_flag
        pass  # ignore extension data
    return v


def write_vps(bw: BitWriter, v: Vps):
    bw.u(v.vps_video_parameter_set_id, 4)
    bw.u(v.vps_base_layer_internal_flag, 1)
    bw.u(v.vps_base_layer_available_flag, 1)
    bw.u(v.vps_max_layers_minus1, 6)
    bw.u(v.vps_max_sub_layers_minus1, 3)
    bw.u(v.vps_temporal_id_nesting_flag, 1)
    bw.u(0xFFFF, 16)
    write_ptl(bw, v.ptl, v.vps_max_sub_layers_minus1)
    bw.u(v.vps_sub_layer_ordering_info_present_flag, 1)
    for i in range(len(v.vps_max_dec_pic_buffering_minus1)):
        bw.ue(v.vps_max_dec_pic_buffering_minus1[i])
        bw.ue(v.vps_max_num_reorder_pics[i])
        bw.ue(v.vps_max_latency_increase_plus1[i])
    bw.u(v.vps_max_layer_id, 6)
    bw.ue(v.vps_num_layer_sets_minus1)
    bw.u(0, 1)  # vps_timing_info_present_flag
    bw.u(0, 1)  # vps_extension_flag
    bw.rbsp_trailing_bits()


def parse_sps(br: BitReader) -> Sps:
    s = Sps()
    s.sps_video_parameter_set_id = br.u(4)
    s.sps_max_sub_layers_minus1 = check_range(
        "7.4.3.2", "sps_max_sub_layers_minus1", br.u(3), 0, 6)
    s.sps_temporal_id_nesting_flag = br.u(1)
    s.ptl = parse_ptl(br, s.sps_max_sub_layers_minus1)
    s.sps_seq_parameter_set_id = check_range(
        "7.4.3.2", "sps_seq_parameter_set_id", br.ue(), 0, 15)
    s.chroma_format_idc = check_range(
        "7.4.3.2", "chroma_format_idc", br.ue(), 0, 3)
    if s.chroma_format_idc == 3:
        s.separate_colour_plane_flag = br.u(1)
    s.pic_width_in_luma_samples = check_range(
        "7.4.3.2", "pic_width_in_luma_samples", br.ue(), 8, 16888)
    s.pic_height_in_luma_samples = check_range(
        "7.4.3.2", "pic_height_in_luma_samples", br.ue(), 8, 16888)
    if br.u(1):  # conformance_window_flag
        s.conf_win = (br.ue(), br.ue(), br.ue(), br.ue())
    s.bit_depth_luma_minus8 = check_range(
        "7.4.3.2", "bit_depth_luma_minus8", br.ue(), 0, 8)
    s.bit_depth_chroma_minus8 = check_range(
        "7.4.3.2", "bit_depth_chroma_minus8", br.ue(), 0, 8)
    s.log2_max_pic_order_cnt_lsb_minus4 = check_range(
        "7.4.3.2", "log2_max_pic_order_cnt_lsb_minus4", br.ue(), 0, 12)
    s.sps_sub_layer_ordering_info_present_flag = br.u(1)
    s.sps_max_dec_pic_buffering_minus1 = []
    s.sps_max_num_reorder_pics = []
    s.sps_max_latency_increase_plus1 = []
    start = 0 if s.sps_sub_layer_ordering_info_present_flag else s.sps_max_sub_layers_minus1
    for _ in range(start, s.sps_max_sub_layers_minus1 + 1):
        s.sps_max_dec_pic_buffering_minus1.append(br.ue())
        s.sps_max_num_reorder_pics.append(br.ue())
        s.sps_max_latency_increase_plus1.append(br.ue())
    s.log2_min_luma_coding_block_size_minus3 = check_range(
        "7.4.3.2", "log2_min_luma_coding_block_size_minus3", br.ue(), 0, 3)
    s.log2_diff_max_min_luma_coding_block_size = check_range(
        "7.4.3.2", "log2_diff_max_min_luma_coding_block_size", br.ue(),
        0, 3)
    s.log2_min_luma_transform_block_size_minus2 = check_range(
        "7.4.3.2", "log2_min_luma_transform_block_size_minus2", br.ue(),
        0, 3)
    s.log2_diff_max_min_luma_transform_block_size = check_range(
        "7.4.3.2", "log2_diff_max_min_luma_transform_block_size", br.ue(),
        0, 3)
    # 7.4.3.2: picture dimensions must be multiples of MinCbSizeY —
    # anything else overruns CB-granular buffers (a Fatal range limit)
    _min_cb = 1 << (s.log2_min_luma_coding_block_size_minus3 + 3)
    if (s.pic_width_in_luma_samples % _min_cb
            or s.pic_height_in_luma_samples % _min_cb):
        raise Violation(
            "7.4.3.2",
            f"picture size {s.pic_width_in_luma_samples}x"
            f"{s.pic_height_in_luma_samples} is not a multiple of "
            f"MinCbSizeY {_min_cb}")
    _mtd_max = (s.log2_min_luma_coding_block_size_minus3 + 3
                + s.log2_diff_max_min_luma_coding_block_size) \
        - (s.log2_min_luma_transform_block_size_minus2 + 2)
    s.max_transform_hierarchy_depth_inter = check_range(
        "7.4.3.2", "max_transform_hierarchy_depth_inter", br.ue(), 0,
        _mtd_max)
    s.max_transform_hierarchy_depth_intra = check_range(
        "7.4.3.2", "max_transform_hierarchy_depth_intra", br.ue(), 0,
        _mtd_max)
    s.scaling_list_enabled_flag = br.u(1)
    if s.scaling_list_enabled_flag:
        if br.u(1):  # sps_scaling_list_data_present_flag
            s.scaling_list_data = parse_scaling_list_data(br)
    s.amp_enabled_flag = br.u(1)
    s.sample_adaptive_offset_enabled_flag = br.u(1)
    s.pcm_enabled_flag = br.u(1)
    if s.pcm_enabled_flag:
        s.pcm_sample_bit_depth_luma_minus1 = br.u(4)
        s.pcm_sample_bit_depth_chroma_minus1 = br.u(4)
        s.log2_min_pcm_luma_coding_block_size_minus3 = br.ue()
        s.log2_diff_max_min_pcm_luma_coding_block_size = br.ue()
        s.pcm_loop_filter_disabled_flag = br.u(1)
    num_st = check_range("7.4.3.2", "num_short_term_ref_pic_sets",
                         br.ue(), 0, 64)
    s.short_term_rps = []
    for i in range(num_st):
        s.short_term_rps.append(
            parse_st_ref_pic_set(br, i, num_st, s.short_term_rps))
    s.long_term_ref_pics_present_flag = br.u(1)
    if s.long_term_ref_pics_present_flag:
        n = check_range("7.4.3.2", "num_long_term_ref_pics_sps",
                        br.ue(), 0, 32)
        for _ in range(n):
            s.lt_ref_pic_poc_lsb_sps.append(
                br.u(s.log2_max_pic_order_cnt_lsb_minus4 + 4))
            s.used_by_curr_pic_lt_sps_flag.append(br.u(1))
    s.sps_temporal_mvp_enabled_flag = br.u(1)
    s.strong_intra_smoothing_enabled_flag = br.u(1)
    if br.u(1):  # vui_parameters_present_flag
        s.vui = parse_vui(br, s)
    if br.u(1):  # sps_extension_present_flag
        pass  # range/multilayer extensions unsupported; data ignored
    return s


def write_sps(bw: BitWriter, s: Sps):
    bw.u(s.sps_video_parameter_set_id, 4)
    bw.u(s.sps_max_sub_layers_minus1, 3)
    bw.u(s.sps_temporal_id_nesting_flag, 1)
    write_ptl(bw, s.ptl, s.sps_max_sub_layers_minus1)
    bw.ue(s.sps_seq_parameter_set_id)
    bw.ue(s.chroma_format_idc)
    if s.chroma_format_idc == 3:
        bw.u(s.separate_colour_plane_flag, 1)
    bw.ue(s.pic_width_in_luma_samples)
    bw.ue(s.pic_height_in_luma_samples)
    has_conf = any(s.conf_win)
    bw.u(1 if has_conf else 0, 1)
    if has_conf:
        for x in s.conf_win:
            bw.ue(x)
    bw.ue(s.bit_depth_luma_minus8)
    bw.ue(s.bit_depth_chroma_minus8)
    bw.ue(s.log2_max_pic_order_cnt_lsb_minus4)
    bw.u(s.sps_sub_layer_ordering_info_present_flag, 1)
    for i in range(len(s.sps_max_dec_pic_buffering_minus1)):
        bw.ue(s.sps_max_dec_pic_buffering_minus1[i])
        bw.ue(s.sps_max_num_reorder_pics[i])
        bw.ue(s.sps_max_latency_increase_plus1[i])
    bw.ue(s.log2_min_luma_coding_block_size_minus3)
    bw.ue(s.log2_diff_max_min_luma_coding_block_size)
    bw.ue(s.log2_min_luma_transform_block_size_minus2)
    bw.ue(s.log2_diff_max_min_luma_transform_block_size)
    bw.ue(s.max_transform_hierarchy_depth_inter)
    bw.ue(s.max_transform_hierarchy_depth_intra)
    bw.u(s.scaling_list_enabled_flag, 1)
    if s.scaling_list_enabled_flag:
        bw.u(0, 1)  # sps_scaling_list_data_present_flag: default lists
    bw.u(s.amp_enabled_flag, 1)
    bw.u(s.sample_adaptive_offset_enabled_flag, 1)
    bw.u(s.pcm_enabled_flag, 1)
    if s.pcm_enabled_flag:
        bw.u(s.pcm_sample_bit_depth_luma_minus1, 4)
        bw.u(s.pcm_sample_bit_depth_chroma_minus1, 4)
        bw.ue(s.log2_min_pcm_luma_coding_block_size_minus3)
        bw.ue(s.log2_diff_max_min_pcm_luma_coding_block_size)
        bw.u(s.pcm_loop_filter_disabled_flag, 1)
    bw.ue(len(s.short_term_rps))
    for i, rps in enumerate(s.short_term_rps):
        write_st_ref_pic_set(bw, rps, i)
    bw.u(s.long_term_ref_pics_present_flag, 1)
    if s.long_term_ref_pics_present_flag:
        bw.ue(len(s.lt_ref_pic_poc_lsb_sps))
        for lsb, used in zip(s.lt_ref_pic_poc_lsb_sps, s.used_by_curr_pic_lt_sps_flag):
            bw.u(lsb, s.log2_max_pic_order_cnt_lsb_minus4 + 4)
            bw.u(used, 1)
    bw.u(s.sps_temporal_mvp_enabled_flag, 1)
    bw.u(s.strong_intra_smoothing_enabled_flag, 1)
    bw.u(int(s.vui is not None), 1)  # vui_parameters_present_flag
    if s.vui is not None:
        write_vui(bw, s.vui)
    bw.u(0, 1)  # sps_extension_present_flag
    bw.rbsp_trailing_bits()


def write_sub_layer_hrd(bw: BitWriter, entries: list, sub_pic: int) -> None:
    for e in entries:
        bw.ue(e["bit_rate_value_minus1"])
        bw.ue(e["cpb_size_value_minus1"])
        if sub_pic:
            bw.ue(e["cpb_size_du_value_minus1"])
            bw.ue(e["bit_rate_du_value_minus1"])
        bw.u(e["cbr_flag"], 1)


def write_hrd(bw: BitWriter, h: HrdParameters, common_inf: int = 1) -> None:
    """Exact inverse of parse_hrd (spec E.2.2)."""
    if common_inf:
        bw.u(h.nal_hrd_parameters_present_flag, 1)
        bw.u(h.vcl_hrd_parameters_present_flag, 1)
        if (h.nal_hrd_parameters_present_flag
                or h.vcl_hrd_parameters_present_flag):
            bw.u(h.sub_pic_hrd_params_present_flag, 1)
            if h.sub_pic_hrd_params_present_flag:
                bw.u(h.tick_divisor_minus2, 8)
                bw.u(h.du_cpb_removal_delay_increment_length_minus1, 5)
                bw.u(h.sub_pic_cpb_params_in_pic_timing_sei_flag, 1)
                bw.u(h.dpb_output_delay_du_length_minus1, 5)
            bw.u(h.bit_rate_scale, 4)
            bw.u(h.cpb_size_scale, 4)
            if h.sub_pic_hrd_params_present_flag:
                bw.u(h.cpb_size_du_scale, 4)
            bw.u(h.initial_cpb_removal_delay_length_minus1, 5)
            bw.u(h.au_cpb_removal_delay_length_minus1, 5)
            bw.u(h.dpb_output_delay_length_minus1, 5)
    for sl in h.sub_layers:
        bw.u(sl["fixed_pic_rate_general_flag"], 1)
        if not sl["fixed_pic_rate_general_flag"]:
            bw.u(sl["fixed_pic_rate_within_cvs_flag"], 1)
        if sl["fixed_pic_rate_within_cvs_flag"]:
            bw.ue(sl["elemental_duration_in_tc_minus1"])
        else:
            bw.u(sl["low_delay_hrd_flag"], 1)
        if not sl["low_delay_hrd_flag"]:
            bw.ue(sl["cpb_cnt_minus1"])
        if h.nal_hrd_parameters_present_flag:
            write_sub_layer_hrd(bw, sl["nal_hrd"],
                                h.sub_pic_hrd_params_present_flag)
        if h.vcl_hrd_parameters_present_flag:
            write_sub_layer_hrd(bw, sl["vcl_hrd"],
                                h.sub_pic_hrd_params_present_flag)


def write_vui(bw: BitWriter, v) -> None:
    """Exact inverse of parse_vui."""
    if v.aspect_ratio_idc is not None:
        bw.u(1, 1)
        bw.u(v.aspect_ratio_idc, 8)
        if v.aspect_ratio_idc == 255:
            bw.u(v.sar_width, 16)
            bw.u(v.sar_height, 16)
    else:
        bw.u(0, 1)
    bw.u(int(v.overscan_appropriate_flag is not None), 1)
    if v.overscan_appropriate_flag is not None:
        bw.u(v.overscan_appropriate_flag, 1)
    if v.video_format is not None:
        bw.u(1, 1)
        bw.u(v.video_format, 3)
        bw.u(v.video_full_range_flag, 1)
        cd = v.colour_primaries is not None
        bw.u(int(cd), 1)
        if cd:
            bw.u(v.colour_primaries, 8)
            bw.u(v.transfer_characteristics, 8)
            bw.u(v.matrix_coeffs, 8)
    else:
        bw.u(0, 1)
    if v.chroma_sample_loc_type_top_field is not None:
        bw.u(1, 1)
        bw.ue(v.chroma_sample_loc_type_top_field)
        bw.ue(v.chroma_sample_loc_type_bottom_field)
    else:
        bw.u(0, 1)
    bw.u(v.neutral_chroma_indication_flag, 1)
    bw.u(v.field_seq_flag, 1)
    bw.u(v.frame_field_info_present_flag, 1)
    if v.default_display_window is not None:
        bw.u(1, 1)
        for x in v.default_display_window:
            bw.ue(x)
    else:
        bw.u(0, 1)
    if v.timing_info is not None:
        bw.u(1, 1)
        bw.u(v.timing_info[0], 32)
        bw.u(v.timing_info[1], 32)
        bw.u(v.poc_proportional_to_timing_flag, 1)
        if v.poc_proportional_to_timing_flag:
            bw.ue(v.num_ticks_poc_diff_one_minus1)
        if v.hrd is not None:
            bw.u(1, 1)
            write_hrd(bw, v.hrd)
        else:
            bw.u(0, 1)  # vui_hrd_parameters_present_flag
    else:
        bw.u(0, 1)
    if v.bitstream_restriction is not None:
        bw.u(1, 1)
        b = v.bitstream_restriction
        bw.u(b["tiles_fixed_structure_flag"], 1)
        bw.u(b["motion_vectors_over_pic_boundaries_flag"], 1)
        bw.u(b["restricted_ref_pic_lists_flag"], 1)
        bw.ue(b["min_spatial_segmentation_idc"])
        bw.ue(b["max_bytes_per_pic_denom"])
        bw.ue(b["max_bits_per_min_cu_denom"])
        bw.ue(b["log2_max_mv_length_horizontal"])
        bw.ue(b["log2_max_mv_length_vertical"])
    else:
        bw.u(0, 1)


def parse_pps(br: BitReader) -> Pps:
    p = Pps()
    p.pps_pic_parameter_set_id = check_range(
        "7.4.3.3", "pps_pic_parameter_set_id", br.ue(), 0, 63)
    p.pps_seq_parameter_set_id = check_range(
        "7.4.3.3", "pps_seq_parameter_set_id", br.ue(), 0, 15)
    p.dependent_slice_segments_enabled_flag = br.u(1)
    p.output_flag_present_flag = br.u(1)
    p.num_extra_slice_header_bits = br.u(3)
    p.sign_data_hiding_enabled_flag = br.u(1)
    p.cabac_init_present_flag = br.u(1)
    p.num_ref_idx_l0_default_active_minus1 = check_range(
        "7.4.3.3", "num_ref_idx_l0_default_active_minus1", br.ue(),
        0, 14)
    p.num_ref_idx_l1_default_active_minus1 = check_range(
        "7.4.3.3", "num_ref_idx_l1_default_active_minus1", br.ue(),
        0, 14)
    p.init_qp_minus26 = br.se()
    p.constrained_intra_pred_flag = br.u(1)
    p.transform_skip_enabled_flag = br.u(1)
    p.cu_qp_delta_enabled_flag = br.u(1)
    if p.cu_qp_delta_enabled_flag:
        p.diff_cu_qp_delta_depth = br.ue()
    p.pps_cb_qp_offset = check_range(
        "7.4.3.3", "pps_cb_qp_offset", br.se(), -12, 12)
    p.pps_cr_qp_offset = check_range(
        "7.4.3.3", "pps_cr_qp_offset", br.se(), -12, 12)
    p.pps_slice_chroma_qp_offsets_present_flag = br.u(1)
    p.weighted_pred_flag = br.u(1)
    p.weighted_bipred_flag = br.u(1)
    p.transquant_bypass_enabled_flag = br.u(1)
    p.tiles_enabled_flag = br.u(1)
    p.entropy_coding_sync_enabled_flag = br.u(1)
    if p.tiles_enabled_flag:
        p.num_tile_columns_minus1 = br.ue()
        p.num_tile_rows_minus1 = br.ue()
        p.uniform_spacing_flag = br.u(1)
        if not p.uniform_spacing_flag:
            p.column_width_minus1 = [br.ue() for _ in range(p.num_tile_columns_minus1)]
            p.row_height_minus1 = [br.ue() for _ in range(p.num_tile_rows_minus1)]
        p.loop_filter_across_tiles_enabled_flag = br.u(1)
    p.pps_loop_filter_across_slices_enabled_flag = br.u(1)
    p.deblocking_filter_control_present_flag = br.u(1)
    if p.deblocking_filter_control_present_flag:
        p.deblocking_filter_override_enabled_flag = br.u(1)
        p.pps_deblocking_filter_disabled_flag = br.u(1)
        if not p.pps_deblocking_filter_disabled_flag:
            p.pps_beta_offset_div2 = check_range(
                "7.4.3.3", "pps_beta_offset_div2", br.se(), -6, 6)
            p.pps_tc_offset_div2 = check_range(
                "7.4.3.3", "pps_tc_offset_div2", br.se(), -6, 6)
    p.pps_scaling_list_data_present_flag = br.u(1)
    if p.pps_scaling_list_data_present_flag:
        p.scaling_list_data = parse_scaling_list_data(br)
    p.lists_modification_present_flag = br.u(1)
    p.log2_parallel_merge_level_minus2 = br.ue()
    p.slice_segment_header_extension_present_flag = br.u(1)
    if br.u(1):  # pps_extension_present_flag
        pass
    return p


def write_pps(bw: BitWriter, p: Pps):
    bw.ue(p.pps_pic_parameter_set_id)
    bw.ue(p.pps_seq_parameter_set_id)
    bw.u(p.dependent_slice_segments_enabled_flag, 1)
    bw.u(p.output_flag_present_flag, 1)
    bw.u(p.num_extra_slice_header_bits, 3)
    bw.u(p.sign_data_hiding_enabled_flag, 1)
    bw.u(p.cabac_init_present_flag, 1)
    bw.ue(p.num_ref_idx_l0_default_active_minus1)
    bw.ue(p.num_ref_idx_l1_default_active_minus1)
    bw.se(p.init_qp_minus26)
    bw.u(p.constrained_intra_pred_flag, 1)
    bw.u(p.transform_skip_enabled_flag, 1)
    bw.u(p.cu_qp_delta_enabled_flag, 1)
    if p.cu_qp_delta_enabled_flag:
        bw.ue(p.diff_cu_qp_delta_depth)
    bw.se(p.pps_cb_qp_offset)
    bw.se(p.pps_cr_qp_offset)
    bw.u(p.pps_slice_chroma_qp_offsets_present_flag, 1)
    bw.u(p.weighted_pred_flag, 1)
    bw.u(p.weighted_bipred_flag, 1)
    bw.u(p.transquant_bypass_enabled_flag, 1)
    bw.u(p.tiles_enabled_flag, 1)
    bw.u(p.entropy_coding_sync_enabled_flag, 1)
    if p.tiles_enabled_flag:
        bw.ue(p.num_tile_columns_minus1)
        bw.ue(p.num_tile_rows_minus1)
        bw.u(p.uniform_spacing_flag, 1)
        if not p.uniform_spacing_flag:
            for c in p.column_width_minus1:
                bw.ue(c)
            for r in p.row_height_minus1:
                bw.ue(r)
        bw.u(p.loop_filter_across_tiles_enabled_flag, 1)
    bw.u(p.pps_loop_filter_across_slices_enabled_flag, 1)
    bw.u(p.deblocking_filter_control_present_flag, 1)
    if p.deblocking_filter_control_present_flag:
        bw.u(p.deblocking_filter_override_enabled_flag, 1)
        bw.u(p.pps_deblocking_filter_disabled_flag, 1)
        if not p.pps_deblocking_filter_disabled_flag:
            bw.se(p.pps_beta_offset_div2)
            bw.se(p.pps_tc_offset_div2)
    bw.u(0, 1)  # pps_scaling_list_data_present_flag
    bw.u(p.lists_modification_present_flag, 1)
    bw.ue(p.log2_parallel_merge_level_minus2)
    bw.u(p.slice_segment_header_extension_present_flag, 1)
    bw.u(0, 1)  # pps_extension_present_flag
    bw.rbsp_trailing_bits()


# ---------------------------------------------------------------- slice header

def _num_pic_total_curr(sh: SliceSegmentHeader, sps: Sps) -> int:
    """NumPicTotalCurr (spec 7.4.7.2 eq 7-57)."""
    rps = _active_rps(sh, sps)
    n = sum(rps.used_s0) + sum(rps.used_s1)
    for (lsb, used, msb_p, msb_c) in sh.long_term_pics:
        n += used
    return n


def _active_rps(sh: SliceSegmentHeader, sps: Sps) -> ShortTermRefPicSet:
    if sh.explicit_rps is not None:
        return sh.explicit_rps
    if sps.short_term_rps:
        return sps.short_term_rps[sh.short_term_ref_pic_set_idx]
    return ShortTermRefPicSet()


def parse_pred_weight_table(br: BitReader, sh: SliceSegmentHeader, sps: Sps) -> dict:
    pwt = {"luma_log2_weight_denom": check_range(
        "7.4.7.3", "luma_log2_weight_denom", br.ue(), 0, 7)}
    chroma = sps.chroma_array_type != 0
    if chroma:
        pwt["delta_chroma_log2_weight_denom"] = br.se()
    for lx in ("l0", "l1") if sh.is_b else ("l0",):
        n = (sh.num_ref_idx_l0_active_minus1 if lx == "l0"
             else sh.num_ref_idx_l1_active_minus1) + 1
        lw = [br.u(1) for _ in range(n)]
        cw = [br.u(1) for _ in range(n)] if chroma else [0] * n
        entries = []
        for i in range(n):
            e = {}
            if lw[i]:
                e["delta_luma_weight"] = br.se()
                e["luma_offset"] = br.se()
            if cw[i]:
                e["chroma"] = [(br.se(), br.se()) for _ in range(2)]
            entries.append(e)
        pwt[lx] = {"luma_flags": lw, "chroma_flags": cw, "entries": entries}
    return pwt


def write_pred_weight_table(bw: BitWriter, sh: SliceSegmentHeader, sps: Sps):
    """Exact inverse of parse_pred_weight_table."""
    pwt = sh.pred_weight_table
    assert pwt is not None, "weighted slice needs sh.pred_weight_table"
    bw.ue(pwt["luma_log2_weight_denom"])
    chroma = sps.chroma_array_type != 0
    if chroma:
        bw.se(pwt.get("delta_chroma_log2_weight_denom", 0))
    for lx in ("l0", "l1") if sh.is_b else ("l0",):
        t = pwt[lx]
        n = (sh.num_ref_idx_l0_active_minus1 if lx == "l0"
             else sh.num_ref_idx_l1_active_minus1) + 1
        assert len(t["entries"]) == n
        for i in range(n):
            bw.u(t["luma_flags"][i], 1)
        if chroma:
            for i in range(n):
                bw.u(t["chroma_flags"][i], 1)
        for i in range(n):
            e = t["entries"][i]
            if t["luma_flags"][i]:
                bw.se(e["delta_luma_weight"])
                bw.se(e["luma_offset"])
            if t["chroma_flags"][i]:
                for dw, do in e["chroma"]:
                    bw.se(dw)
                    bw.se(do)


def parse_slice_segment_header(br: BitReader, nal_unit_type: int,
                               temporal_id: int, ps: ParamSets) -> SliceSegmentHeader:
    sh = SliceSegmentHeader()
    sh.nal_unit_type = nal_unit_type
    sh.temporal_id = temporal_id
    sh.first_slice_segment_in_pic_flag = br.u(1)
    if T.is_irap(nal_unit_type):
        sh.no_output_of_prior_pics_flag = br.u(1)
    sh.slice_pic_parameter_set_id = check_range(
        "7.4.7.1", "slice_pic_parameter_set_id", br.ue(), 0, 63)
    sps, pps = ps.activate(sh.slice_pic_parameter_set_id)
    if not sh.first_slice_segment_in_pic_flag:
        if pps.dependent_slice_segments_enabled_flag:
            sh.dependent_slice_segment_flag = br.u(1)
        sh.slice_segment_address = br.u(sps.ctb_addr_bits)
    if not sh.dependent_slice_segment_flag:
        for _ in range(pps.num_extra_slice_header_bits):
            br.u(1)
        sh.slice_type = check_range(
            "7.4.7.1", "slice_type", br.ue(), 0, 2)
        if pps.output_flag_present_flag:
            sh.pic_output_flag = br.u(1)
        if sps.separate_colour_plane_flag:
            sh.colour_plane_id = check_range(
                "7.4.7.1", "colour_plane_id", br.u(2), 0, 2)
        if not T.is_idr(nal_unit_type):
            sh.slice_pic_order_cnt_lsb = br.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            sh.short_term_ref_pic_set_sps_flag = br.u(1)
            if not sh.short_term_ref_pic_set_sps_flag:
                n = len(sps.short_term_rps)
                sh.explicit_rps = parse_st_ref_pic_set(br, n, n, sps.short_term_rps)
            elif len(sps.short_term_rps) > 1:
                bits = math.ceil(math.log2(len(sps.short_term_rps)))
                sh.short_term_ref_pic_set_idx = br.u(bits)
            if sps.long_term_ref_pics_present_flag:
                num_lt_sps = 0
                if sps.lt_ref_pic_poc_lsb_sps:
                    num_lt_sps = br.ue()
                num_lt_pics = br.ue()
                sh.num_long_term_sps = num_lt_sps
                for i in range(num_lt_sps + num_lt_pics):
                    if i < num_lt_sps:
                        idx = 0
                        if len(sps.lt_ref_pic_poc_lsb_sps) > 1:
                            idx = br.u(math.ceil(math.log2(len(sps.lt_ref_pic_poc_lsb_sps))))
                        lsb = sps.lt_ref_pic_poc_lsb_sps[idx]
                        used = sps.used_by_curr_pic_lt_sps_flag[idx]
                    else:
                        lsb = br.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
                        used = br.u(1)
                    msb_present = br.u(1)
                    msb_cycle = br.ue() if msb_present else 0
                    sh.long_term_pics.append((lsb, used, msb_present, msb_cycle))
            if sps.sps_temporal_mvp_enabled_flag:
                sh.slice_temporal_mvp_enabled_flag = br.u(1)
        if sps.sample_adaptive_offset_enabled_flag:
            sh.slice_sao_luma_flag = br.u(1)
            if sps.chroma_array_type != 0:
                sh.slice_sao_chroma_flag = br.u(1)
        if not sh.is_i:
            sh.num_ref_idx_l0_active_minus1 = pps.num_ref_idx_l0_default_active_minus1
            sh.num_ref_idx_l1_active_minus1 = pps.num_ref_idx_l1_default_active_minus1
            sh.num_ref_idx_active_override_flag = br.u(1)
            if sh.num_ref_idx_active_override_flag:
                sh.num_ref_idx_l0_active_minus1 = check_range(
                    "7.4.7.1", "num_ref_idx_l0_active_minus1",
                    br.ue(), 0, 14)
                if sh.is_b:
                    sh.num_ref_idx_l1_active_minus1 = check_range(
                        "7.4.7.1", "num_ref_idx_l1_active_minus1",
                        br.ue(), 0, 14)
            nptc = _num_pic_total_curr(sh, sps)
            if pps.lists_modification_present_flag and nptc > 1:
                bits = math.ceil(math.log2(nptc))
                sh.ref_pic_list_modification_flag_l0 = br.u(1)
                if sh.ref_pic_list_modification_flag_l0:
                    sh.list_entry_l0 = [br.u(bits) for _ in
                                        range(sh.num_ref_idx_l0_active_minus1 + 1)]
                if sh.is_b:
                    sh.ref_pic_list_modification_flag_l1 = br.u(1)
                    if sh.ref_pic_list_modification_flag_l1:
                        sh.list_entry_l1 = [br.u(bits) for _ in
                                            range(sh.num_ref_idx_l1_active_minus1 + 1)]
            if sh.is_b:
                sh.mvd_l1_zero_flag = br.u(1)
            if pps.cabac_init_present_flag:
                sh.cabac_init_flag = br.u(1)
            if sh.slice_temporal_mvp_enabled_flag:
                if sh.is_b:
                    sh.collocated_from_l0_flag = br.u(1)
                if ((sh.collocated_from_l0_flag and sh.num_ref_idx_l0_active_minus1 > 0)
                        or (not sh.collocated_from_l0_flag
                            and sh.num_ref_idx_l1_active_minus1 > 0)):
                    sh.collocated_ref_idx = check_range(
                        "7.4.7.1", "collocated_ref_idx", br.ue(),
                        0, 14)
            if ((pps.weighted_pred_flag and sh.is_p)
                    or (pps.weighted_bipred_flag and sh.is_b)):
                sh.pred_weight_table = parse_pred_weight_table(br, sh, sps)
            sh.five_minus_max_num_merge_cand = check_range(
                "7.4.7.1", "five_minus_max_num_merge_cand",
                br.ue(), 0, 4)
            sh.max_num_merge_cand = 5 - sh.five_minus_max_num_merge_cand
        sh.slice_qp_delta = br.se()
        if pps.pps_slice_chroma_qp_offsets_present_flag:
            sh.slice_cb_qp_offset = br.se()
            sh.slice_cr_qp_offset = br.se()
        if pps.deblocking_filter_control_present_flag:
            if pps.deblocking_filter_override_enabled_flag:
                sh.deblocking_filter_override_flag = br.u(1)
            if sh.deblocking_filter_override_flag:
                sh.slice_deblocking_filter_disabled_flag = br.u(1)
                if not sh.slice_deblocking_filter_disabled_flag:
                    sh.slice_beta_offset_div2 = check_range(
                        "7.4.7.1", "slice_beta_offset_div2",
                        br.se(), -6, 6)
                    sh.slice_tc_offset_div2 = check_range(
                        "7.4.7.1", "slice_tc_offset_div2",
                        br.se(), -6, 6)
            else:
                sh.slice_deblocking_filter_disabled_flag = pps.pps_deblocking_filter_disabled_flag
                sh.slice_beta_offset_div2 = pps.pps_beta_offset_div2
                sh.slice_tc_offset_div2 = pps.pps_tc_offset_div2
        sh.slice_loop_filter_across_slices_enabled_flag = pps.pps_loop_filter_across_slices_enabled_flag
        if (pps.pps_loop_filter_across_slices_enabled_flag
                and (sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
                     or not sh.slice_deblocking_filter_disabled_flag)):
            sh.slice_loop_filter_across_slices_enabled_flag = br.u(1)
    if pps.tiles_enabled_flag or pps.entropy_coding_sync_enabled_flag:
        sh.num_entry_point_offsets = br.ue()
        if sh.num_entry_point_offsets > 0:
            sh.offset_len_minus1 = check_range(
                "7.4.7.1", "offset_len_minus1", br.ue(), 0, 31)
            sh.entry_point_offset_minus1 = [
                br.u(sh.offset_len_minus1 + 1)
                for _ in range(sh.num_entry_point_offsets)]
    if pps.slice_segment_header_extension_present_flag:
        n = br.ue()
        for _ in range(n):
            br.u(8)
    br.byte_alignment()
    sh.slice_qp_y = 26 + pps.init_qp_minus26 + sh.slice_qp_delta
    return sh


def write_slice_segment_header(bw: BitWriter, sh: SliceSegmentHeader,
                               sps: Sps, pps: Pps):
    """Writes the non-dependent slice header forms the encoder emits."""
    bw.u(sh.first_slice_segment_in_pic_flag, 1)
    if T.is_irap(sh.nal_unit_type):
        bw.u(sh.no_output_of_prior_pics_flag, 1)
    bw.ue(sh.slice_pic_parameter_set_id)
    if not sh.first_slice_segment_in_pic_flag:
        if pps.dependent_slice_segments_enabled_flag:
            bw.u(sh.dependent_slice_segment_flag, 1)
        bw.u(sh.slice_segment_address, sps.ctb_addr_bits)
    if sh.dependent_slice_segment_flag:
        _write_slice_header_tail(bw, sh, pps)
        return
    for _ in range(pps.num_extra_slice_header_bits):
        bw.u(0, 1)
    bw.ue(sh.slice_type)
    if pps.output_flag_present_flag:
        bw.u(sh.pic_output_flag, 1)
    if not T.is_idr(sh.nal_unit_type):
        bw.u(sh.slice_pic_order_cnt_lsb, sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        bw.u(sh.short_term_ref_pic_set_sps_flag, 1)
        if not sh.short_term_ref_pic_set_sps_flag:
            n = len(sps.short_term_rps)
            write_st_ref_pic_set(bw, sh.explicit_rps, n)
        elif len(sps.short_term_rps) > 1:
            bw.u(sh.short_term_ref_pic_set_idx,
                 math.ceil(math.log2(len(sps.short_term_rps))))
        if sps.long_term_ref_pics_present_flag:
            if sps.lt_ref_pic_poc_lsb_sps:
                bw.ue(sh.num_long_term_sps)
            bw.ue(len(sh.long_term_pics) - sh.num_long_term_sps)
            for i, (lsb, used, msb_p, msb_c) in enumerate(sh.long_term_pics):
                if i >= sh.num_long_term_sps:
                    bw.u(lsb, sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
                    bw.u(used, 1)
                bw.u(msb_p, 1)
                if msb_p:
                    bw.ue(msb_c)
        if sps.sps_temporal_mvp_enabled_flag:
            bw.u(sh.slice_temporal_mvp_enabled_flag, 1)
    if sps.sample_adaptive_offset_enabled_flag:
        bw.u(sh.slice_sao_luma_flag, 1)
        if sps.chroma_array_type != 0:
            bw.u(sh.slice_sao_chroma_flag, 1)
    if not sh.is_i:
        bw.u(sh.num_ref_idx_active_override_flag, 1)
        if sh.num_ref_idx_active_override_flag:
            bw.ue(sh.num_ref_idx_l0_active_minus1)
            if sh.is_b:
                bw.ue(sh.num_ref_idx_l1_active_minus1)
        nptc = _num_pic_total_curr(sh, sps)
        if pps.lists_modification_present_flag and nptc > 1:
            bits = math.ceil(math.log2(nptc))
            bw.u(sh.ref_pic_list_modification_flag_l0, 1)
            if sh.ref_pic_list_modification_flag_l0:
                for e in sh.list_entry_l0:
                    bw.u(e, bits)
            if sh.is_b:
                bw.u(sh.ref_pic_list_modification_flag_l1, 1)
                if sh.ref_pic_list_modification_flag_l1:
                    for e in sh.list_entry_l1:
                        bw.u(e, bits)
        if sh.is_b:
            bw.u(sh.mvd_l1_zero_flag, 1)
        if pps.cabac_init_present_flag:
            bw.u(sh.cabac_init_flag, 1)
        if sh.slice_temporal_mvp_enabled_flag:
            if sh.is_b:
                bw.u(sh.collocated_from_l0_flag, 1)
            if ((sh.collocated_from_l0_flag and sh.num_ref_idx_l0_active_minus1 > 0)
                    or (not sh.collocated_from_l0_flag
                        and sh.num_ref_idx_l1_active_minus1 > 0)):
                bw.ue(sh.collocated_ref_idx)
        if ((pps.weighted_pred_flag and sh.is_p)
                or (pps.weighted_bipred_flag and sh.is_b)):
            write_pred_weight_table(bw, sh, sps)
        bw.ue(sh.five_minus_max_num_merge_cand)
    bw.se(sh.slice_qp_delta)
    if pps.pps_slice_chroma_qp_offsets_present_flag:
        bw.se(sh.slice_cb_qp_offset)
        bw.se(sh.slice_cr_qp_offset)
    if pps.deblocking_filter_control_present_flag:
        if pps.deblocking_filter_override_enabled_flag:
            bw.u(sh.deblocking_filter_override_flag, 1)
        if sh.deblocking_filter_override_flag:
            bw.u(sh.slice_deblocking_filter_disabled_flag, 1)
            if not sh.slice_deblocking_filter_disabled_flag:
                bw.se(sh.slice_beta_offset_div2)
                bw.se(sh.slice_tc_offset_div2)
    if (pps.pps_loop_filter_across_slices_enabled_flag
            and (sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
                 or not sh.slice_deblocking_filter_disabled_flag)):
        bw.u(sh.slice_loop_filter_across_slices_enabled_flag, 1)
    _write_slice_header_tail(bw, sh, pps)


def _write_slice_header_tail(bw: BitWriter, sh: SliceSegmentHeader, pps: Pps):
    """Entry points + byte alignment — common to dependent and independent
    slice segment headers."""
    if pps.tiles_enabled_flag or pps.entropy_coding_sync_enabled_flag:
        bw.ue(sh.num_entry_point_offsets)
        if sh.num_entry_point_offsets > 0:
            bw.ue(sh.offset_len_minus1)
            for e in sh.entry_point_offset_minus1:
                bw.u(e, sh.offset_len_minus1 + 1)
    bw.byte_alignment()
