"""HEVC parameter sets and slice headers: dataclasses + derived variables.

Syntax order follows ITU-T H.265 clauses 7.3.2 (VPS/SPS/PPS), 7.3.6 (slice
segment header). Parse/write functions live in hevc.header_syntax — written
once, used by both encoder and decoder (the explicit-function analogue of the
reference's single-source template syntax, turing/Syntax.h:21-22 and
turing/SyntaxRbsp.hpp).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ProfileTierLevel:
    general_profile_space: int = 0
    general_tier_flag: int = 0
    general_profile_idc: int = 1  # Main
    general_profile_compatibility_flags: int = 0  # 32-bit mask, bit i = flag[i]
    general_progressive_source_flag: int = 1
    general_interlaced_source_flag: int = 0
    general_non_packed_constraint_flag: int = 0
    general_frame_only_constraint_flag: int = 1
    general_reserved_44bits: int = 0
    general_level_idc: int = 120  # level 4.0
    sub_layer_profile_present: List[int] = field(default_factory=list)
    sub_layer_level_present: List[int] = field(default_factory=list)
    sub_layer_raw: List[tuple] = field(default_factory=list)  # (profile_bits88, level_idc)


@dataclass
class ShortTermRefPicSet:
    """Derived form of st_ref_pic_set (spec 7.4.8): explicit delta POCs."""
    delta_poc_s0: List[int] = field(default_factory=list)  # negative deltas
    used_s0: List[int] = field(default_factory=list)
    delta_poc_s1: List[int] = field(default_factory=list)  # positive deltas
    used_s1: List[int] = field(default_factory=list)

    @property
    def num_negative_pics(self) -> int:
        return len(self.delta_poc_s0)

    @property
    def num_positive_pics(self) -> int:
        return len(self.delta_poc_s1)

    @property
    def num_delta_pocs(self) -> int:
        return len(self.delta_poc_s0) + len(self.delta_poc_s1)


@dataclass
class HrdParameters:
    # stored raw; HRD is consumed for conformance/timing only
    nal_hrd_parameters_present_flag: int = 0
    vcl_hrd_parameters_present_flag: int = 0
    sub_pic_hrd_params_present_flag: int = 0
    tick_divisor_minus2: int = 0
    du_cpb_removal_delay_increment_length_minus1: int = 0
    sub_pic_cpb_params_in_pic_timing_sei_flag: int = 0
    dpb_output_delay_du_length_minus1: int = 0
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    cpb_size_du_scale: int = 0
    initial_cpb_removal_delay_length_minus1: int = 23
    au_cpb_removal_delay_length_minus1: int = 23
    dpb_output_delay_length_minus1: int = 23
    sub_layers: List[dict] = field(default_factory=list)


@dataclass
class VuiParameters:
    aspect_ratio_idc: Optional[int] = None
    sar_width: int = 0
    sar_height: int = 0
    overscan_appropriate_flag: Optional[int] = None
    video_format: Optional[int] = None
    video_full_range_flag: int = 0
    colour_primaries: Optional[int] = None
    transfer_characteristics: Optional[int] = None
    matrix_coeffs: Optional[int] = None
    chroma_sample_loc_type_top_field: Optional[int] = None
    chroma_sample_loc_type_bottom_field: int = 0
    neutral_chroma_indication_flag: int = 0
    field_seq_flag: int = 0
    frame_field_info_present_flag: int = 0
    default_display_window: Optional[tuple] = None  # (l, r, t, b)
    timing_info: Optional[tuple] = None  # (num_units_in_tick, time_scale)
    poc_proportional_to_timing_flag: int = 0
    num_ticks_poc_diff_one_minus1: int = 0
    hrd: Optional[HrdParameters] = None
    bitstream_restriction: Optional[dict] = None


@dataclass
class ScalingListData:
    """scaling_list_data() fully derived: lists[sizeId][matrixId] and DCs."""
    lists: List[List[np.ndarray]] = field(default_factory=list)
    dc: List[List[int]] = field(default_factory=list)  # sizeId 2,3 -> index 0,1


@dataclass
class Vps:
    vps_video_parameter_set_id: int = 0
    vps_base_layer_internal_flag: int = 1
    vps_base_layer_available_flag: int = 1
    vps_max_layers_minus1: int = 0
    vps_max_sub_layers_minus1: int = 0
    vps_temporal_id_nesting_flag: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    vps_sub_layer_ordering_info_present_flag: int = 0
    vps_max_dec_pic_buffering_minus1: List[int] = field(default_factory=lambda: [4])
    vps_max_num_reorder_pics: List[int] = field(default_factory=lambda: [3])
    vps_max_latency_increase_plus1: List[int] = field(default_factory=lambda: [0])
    vps_max_layer_id: int = 0
    vps_num_layer_sets_minus1: int = 0
    vps_timing_info_present_flag: int = 0
    vps_num_units_in_tick: int = 0
    vps_time_scale: int = 0
    vps_poc_proportional_to_timing_flag: int = 0
    vps_num_ticks_poc_diff_one_minus1: int = 0


@dataclass
class Sps:
    sps_video_parameter_set_id: int = 0
    sps_max_sub_layers_minus1: int = 0
    sps_temporal_id_nesting_flag: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    sps_seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: int = 0
    pic_width_in_luma_samples: int = 0
    pic_height_in_luma_samples: int = 0
    conf_win: tuple = (0, 0, 0, 0)  # left, right, top, bottom
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    log2_max_pic_order_cnt_lsb_minus4: int = 4
    sps_sub_layer_ordering_info_present_flag: int = 0
    sps_max_dec_pic_buffering_minus1: List[int] = field(default_factory=lambda: [4])
    sps_max_num_reorder_pics: List[int] = field(default_factory=lambda: [3])
    sps_max_latency_increase_plus1: List[int] = field(default_factory=lambda: [0])
    log2_min_luma_coding_block_size_minus3: int = 0
    log2_diff_max_min_luma_coding_block_size: int = 3
    log2_min_luma_transform_block_size_minus2: int = 0
    log2_diff_max_min_luma_transform_block_size: int = 3
    max_transform_hierarchy_depth_inter: int = 1
    max_transform_hierarchy_depth_intra: int = 1
    scaling_list_enabled_flag: int = 0
    scaling_list_data: Optional[ScalingListData] = None
    amp_enabled_flag: int = 0
    sample_adaptive_offset_enabled_flag: int = 1
    pcm_enabled_flag: int = 0
    pcm_sample_bit_depth_luma_minus1: int = 7
    pcm_sample_bit_depth_chroma_minus1: int = 7
    log2_min_pcm_luma_coding_block_size_minus3: int = 0
    log2_diff_max_min_pcm_luma_coding_block_size: int = 0
    pcm_loop_filter_disabled_flag: int = 0
    short_term_rps: List[ShortTermRefPicSet] = field(default_factory=list)
    long_term_ref_pics_present_flag: int = 0
    lt_ref_pic_poc_lsb_sps: List[int] = field(default_factory=list)
    used_by_curr_pic_lt_sps_flag: List[int] = field(default_factory=list)
    sps_temporal_mvp_enabled_flag: int = 1
    strong_intra_smoothing_enabled_flag: int = 1
    vui: Optional[VuiParameters] = None

    # ---- derived variables (spec 7.4.3.2.1) ----
    @property
    def chroma_array_type(self) -> int:
        return 0 if self.separate_colour_plane_flag else self.chroma_format_idc

    @property
    def sub_width_c(self) -> int:
        return 2 if self.chroma_format_idc in (1, 2) else 1

    @property
    def sub_height_c(self) -> int:
        return 2 if self.chroma_format_idc == 1 else 1

    @property
    def bit_depth_y(self) -> int:
        return 8 + self.bit_depth_luma_minus8

    @property
    def bit_depth_c(self) -> int:
        return 8 + self.bit_depth_chroma_minus8

    @property
    def qp_bd_offset_y(self) -> int:
        return 6 * self.bit_depth_luma_minus8

    @property
    def qp_bd_offset_c(self) -> int:
        return 6 * self.bit_depth_chroma_minus8

    @property
    def max_pic_order_cnt_lsb(self) -> int:
        return 1 << (self.log2_max_pic_order_cnt_lsb_minus4 + 4)

    @property
    def min_cb_log2_size_y(self) -> int:
        return self.log2_min_luma_coding_block_size_minus3 + 3

    @property
    def ctb_log2_size_y(self) -> int:
        return self.min_cb_log2_size_y + self.log2_diff_max_min_luma_coding_block_size

    @property
    def ctb_size_y(self) -> int:
        return 1 << self.ctb_log2_size_y

    @property
    def min_tb_log2_size_y(self) -> int:
        return self.log2_min_luma_transform_block_size_minus2 + 2

    @property
    def max_tb_log2_size_y(self) -> int:
        return self.min_tb_log2_size_y + self.log2_diff_max_min_luma_transform_block_size

    @property
    def pic_width_in_ctbs_y(self) -> int:
        return -(-self.pic_width_in_luma_samples // self.ctb_size_y)

    @property
    def pic_height_in_ctbs_y(self) -> int:
        return -(-self.pic_height_in_luma_samples // self.ctb_size_y)

    @property
    def pic_size_in_ctbs_y(self) -> int:
        return self.pic_width_in_ctbs_y * self.pic_height_in_ctbs_y

    @property
    def pic_width_in_min_cbs_y(self) -> int:
        return self.pic_width_in_luma_samples >> self.min_cb_log2_size_y

    @property
    def pic_height_in_min_cbs_y(self) -> int:
        return self.pic_height_in_luma_samples >> self.min_cb_log2_size_y

    @property
    def pic_size_in_samples_y(self) -> int:
        return self.pic_width_in_luma_samples * self.pic_height_in_luma_samples

    @property
    def ctb_addr_bits(self) -> int:
        """Bits for slice_segment_address: Ceil(Log2(PicSizeInCtbsY))."""
        return max(1, math.ceil(math.log2(max(2, self.pic_size_in_ctbs_y))))


@dataclass
class Pps:
    pps_pic_parameter_set_id: int = 0
    pps_seq_parameter_set_id: int = 0
    dependent_slice_segments_enabled_flag: int = 0
    output_flag_present_flag: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding_enabled_flag: int = 1
    cabac_init_present_flag: int = 0
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    init_qp_minus26: int = 0
    constrained_intra_pred_flag: int = 0
    transform_skip_enabled_flag: int = 0
    cu_qp_delta_enabled_flag: int = 0
    diff_cu_qp_delta_depth: int = 0
    pps_cb_qp_offset: int = 0
    pps_cr_qp_offset: int = 0
    pps_slice_chroma_qp_offsets_present_flag: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_flag: int = 0
    transquant_bypass_enabled_flag: int = 0
    tiles_enabled_flag: int = 0
    entropy_coding_sync_enabled_flag: int = 1
    num_tile_columns_minus1: int = 0
    num_tile_rows_minus1: int = 0
    uniform_spacing_flag: int = 1
    column_width_minus1: List[int] = field(default_factory=list)
    row_height_minus1: List[int] = field(default_factory=list)
    loop_filter_across_tiles_enabled_flag: int = 1
    pps_loop_filter_across_slices_enabled_flag: int = 1
    deblocking_filter_control_present_flag: int = 0
    deblocking_filter_override_enabled_flag: int = 0
    pps_deblocking_filter_disabled_flag: int = 0
    pps_beta_offset_div2: int = 0
    pps_tc_offset_div2: int = 0
    pps_scaling_list_data_present_flag: int = 0
    scaling_list_data: Optional[ScalingListData] = None
    lists_modification_present_flag: int = 0
    log2_parallel_merge_level_minus2: int = 0
    slice_segment_header_extension_present_flag: int = 0

    def tile_column_boundaries(self, sps: Sps) -> List[int]:
        """colBd in CTBs, length num_tile_columns+2-1 (spec 6.5.1)."""
        n = self.num_tile_columns_minus1 + 1
        w = sps.pic_width_in_ctbs_y
        if self.uniform_spacing_flag:
            widths = [((i + 1) * w) // n - (i * w) // n for i in range(n)]
        else:
            widths = [c + 1 for c in self.column_width_minus1]
            widths.append(w - sum(widths))
        bd = [0]
        for cw in widths:
            bd.append(bd[-1] + cw)
        return bd

    def tile_row_boundaries(self, sps: Sps) -> List[int]:
        n = self.num_tile_rows_minus1 + 1
        h = sps.pic_height_in_ctbs_y
        if self.uniform_spacing_flag:
            heights = [((i + 1) * h) // n - (i * h) // n for i in range(n)]
        else:
            heights = [r + 1 for r in self.row_height_minus1]
            heights.append(h - sum(heights))
        bd = [0]
        for rh in heights:
            bd.append(bd[-1] + rh)
        return bd


@dataclass
class SliceSegmentHeader:
    nal_unit_type: int = 0
    temporal_id: int = 0
    first_slice_segment_in_pic_flag: int = 1
    no_output_of_prior_pics_flag: int = 0
    slice_pic_parameter_set_id: int = 0
    dependent_slice_segment_flag: int = 0
    slice_segment_address: int = 0
    slice_type: int = 2  # I
    pic_output_flag: int = 1
    colour_plane_id: int = 0
    slice_pic_order_cnt_lsb: int = 0
    short_term_ref_pic_set_sps_flag: int = 0
    short_term_ref_pic_set_idx: int = 0
    explicit_rps: Optional[ShortTermRefPicSet] = None
    # long-term pics: list of (poc_lsb_lt, used_flag, msb_present, msb_cycle)
    num_long_term_sps: int = 0
    long_term_pics: List[tuple] = field(default_factory=list)
    slice_temporal_mvp_enabled_flag: int = 0
    slice_sao_luma_flag: int = 0
    slice_sao_chroma_flag: int = 0
    num_ref_idx_active_override_flag: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    ref_pic_list_modification_flag_l0: int = 0
    list_entry_l0: List[int] = field(default_factory=list)
    ref_pic_list_modification_flag_l1: int = 0
    list_entry_l1: List[int] = field(default_factory=list)
    mvd_l1_zero_flag: int = 0
    cabac_init_flag: int = 0
    collocated_from_l0_flag: int = 1
    collocated_ref_idx: int = 0
    pred_weight_table: Optional[dict] = None
    five_minus_max_num_merge_cand: int = 0
    slice_qp_delta: int = 0
    slice_cb_qp_offset: int = 0
    slice_cr_qp_offset: int = 0
    deblocking_filter_override_flag: int = 0
    slice_deblocking_filter_disabled_flag: int = 0
    slice_beta_offset_div2: int = 0
    slice_tc_offset_div2: int = 0
    slice_loop_filter_across_slices_enabled_flag: int = 1
    num_entry_point_offsets: int = 0
    offset_len_minus1: int = 0
    entry_point_offset_minus1: List[int] = field(default_factory=list)
    # derived / context
    slice_qp_y: int = 26
    max_num_merge_cand: int = 5

    @property
    def is_i(self) -> bool:
        return self.slice_type == 2

    @property
    def is_p(self) -> bool:
        return self.slice_type == 1

    @property
    def is_b(self) -> bool:
        return self.slice_type == 0

    def init_type(self) -> int:
        """CABAC initType (spec Table 9-4)."""
        if self.is_i:
            return 0
        if self.is_p:
            return 2 if self.cabac_init_flag else 1
        return 1 if self.cabac_init_flag else 2


@dataclass
class ParamSets:
    """Tables of parameter sets by id + 'active' pointers.

    Parity reference: Table<X>/Active<X> maps, turing/StateParameterSets.h.
    """
    vps: Dict[int, Vps] = field(default_factory=dict)
    sps: Dict[int, Sps] = field(default_factory=dict)
    pps: Dict[int, Pps] = field(default_factory=dict)

    def activate(self, slice_pps_id: int):
        pps = self.pps[slice_pps_id]
        sps = self.sps[pps.pps_seq_parameter_set_id]
        return sps, pps
