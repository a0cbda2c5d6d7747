"""Decision tensors ("picture plan"): the fully-parsed, pixel-independent
representation of one coded picture.

This is the TPU-native analogue of the reference's CodedData decision stream
(turing/CodedData.h:37 "Encoder decisions serialised to a sequence of
uint16_t") — but as dense numpy tensors at 4x4 min-block granularity, so the
reconstruction stage can consume them as batched device arrays instead of a
sequential cursor.

Parse (host, serial CABAC) fills a PicturePlan; reconstruction (device,
batched) reads it. The split works because HEVC syntax parsing never depends
on reconstructed sample values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from turingcodec_tpu_torch.hevc.params import Pps, SliceSegmentHeader, Sps


class CuRecordList(list):
    """plan.cu_list: CuInfo entries, materialized lazily.

    The native slice parser leaves its raw (n, 8) cu / (m, 9) tu int32
    record arrays in `.parts`; the native reconstruction paths consume
    those directly (no Python objects). Any list-style access (iteration,
    len, indexing — e.g. the numpy fallbacks, device_recon, WP path)
    materializes CuInfo entries on first use. Record layout:
    cu = (x0, y0, log2, pred_mode, part_mode, skip, tq_bypass, n_tus),
    tu = (x0, y0, log2, blk_idx, x_base, y_base, cbf_y, cbf_cb, cbf_cr).
    """

    def __init__(self):
        super().__init__()
        self.parts = []

    def _materialize(self):
        if not self.parts:
            return
        from turingcodec_tpu_torch.decode.ctu_parse import CuInfo
        parts, self.parts = self.parts, []
        for cu_arr, tu_arr in parts:
            tu_list = [tuple(t) for t in tu_arr.tolist()]
            ti = 0
            for (x0, y0, log2, pred, pm, skip, tqb, ntus) in \
                    cu_arr.tolist():
                cu = CuInfo()
                cu.x0, cu.y0, cu.log2_size = x0, y0, log2
                cu.pred_mode = pred
                cu.part_mode = pm
                cu.skip = bool(skip)
                cu.tq_bypass = bool(tqb)
                cu.tus = tu_list[ti:ti + ntus]
                ti += ntus
                self.append(cu)

    def __iter__(self):
        self._materialize()
        return super().__iter__()

    def __len__(self):
        self._materialize()
        return super().__len__()

    def __getitem__(self, i):
        self._materialize()
        return super().__getitem__(i)

    def record_arrays(self):
        """(cu, tu) concatenated int32 record arrays, or None when the
        records came from the Python parser as CuInfo objects."""
        if not self.parts or super().__len__():
            return None
        cu = (np.concatenate([p[0] for p in self.parts])
              if len(self.parts) > 1 else self.parts[0][0])
        tu = (np.concatenate([p[1] for p in self.parts])
              if len(self.parts) > 1 else self.parts[0][1])
        return cu, tu


@dataclass
class PicturePlan:
    sps: Sps
    pps: Pps
    # one entry per slice segment, in decode order
    slice_headers: List[SliceSegmentHeader] = field(default_factory=list)

    # --- per 4x4 min-block tensors (H4, W4) ---
    ct_depth: np.ndarray = None
    cu_pred_mode: np.ndarray = None    # 0 inter, 1 intra
    part_mode: np.ndarray = None       # PartMode of the covering CU
    skip_flag: np.ndarray = None
    tq_bypass: np.ndarray = None
    pcm_flag: np.ndarray = None
    intra_mode_y: np.ndarray = None    # 0..34
    intra_mode_c: np.ndarray = None
    mv: np.ndarray = None              # (2, H4, W4, 2) int16 quarter-pel (x, y)
    ref_idx: np.ndarray = None         # (2, H4, W4) int8, -1 = not used
    # PU syntax record (for encoder writing / plan round-trips)
    merge_flag: np.ndarray = None
    merge_idx: np.ndarray = None
    mvd: np.ndarray = None             # (2, H4, W4, 2) int16
    mvp_flag: np.ndarray = None        # (2, H4, W4)
    ref_poc: np.ndarray = None         # (2, H4, W4) int32 POC of the ref (for TMVP/deblock)
    ref_is_lt: np.ndarray = None       # (2, H4, W4) uint8 long-term flag
    qp_y: np.ndarray = None            # int8 per block
    cu_size_log2: np.ndarray = None    # log2 CbSize covering this block
    pu_id: np.ndarray = None           # unique PU index per block (for edges)
    cu_id: np.ndarray = None           # unique CU index
    tu_log2: np.ndarray = None         # log2 size of the TU covering (luma)
    tu_id: np.ndarray = None
    cbf_y: np.ndarray = None
    cbf_cb: np.ndarray = None          # at chroma TU granularity, stored per luma block
    cbf_cr: np.ndarray = None
    transform_skip_y: np.ndarray = None
    transform_skip_cb: np.ndarray = None
    transform_skip_cr: np.ndarray = None
    slice_idx: np.ndarray = None       # per CTU (Hc, Wc) int32 slice number
    # coefficient planes (TransCoeffLevel before scaling)
    coeff_y: np.ndarray = None         # (H, W) int16
    coeff_cb: np.ndarray = None        # (H/2, W/2) int16
    coeff_cr: np.ndarray = None
    # PCM raw samples (rare); list of (x0, y0, log2size, y, cb, cr arrays)
    pcm_samples: list = field(default_factory=list)
    # decode-order CU records (with TU leaf lists) for reconstruction replay
    cu_list: list = None  # CuRecordList, set in __post_init__
    # SAO: (Hc, Wc, 3) type  0=off 1=band 2=edge; class: edge dir or band pos
    sao_type: np.ndarray = None
    sao_class: np.ndarray = None       # (Hc, Wc, 3)
    sao_offsets: np.ndarray = None     # (Hc, Wc, 3, 4) int8
    sao_merge: np.ndarray = None       # (Hc, Wc) 0=new 1=left 2=up (encode)

    def __post_init__(self):
        if self.cu_list is None:
            self.cu_list = CuRecordList()
        sps = self.sps
        w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        w4, h4 = w // 4, h // 4
        wc, hc = sps.pic_width_in_ctbs_y, sps.pic_height_in_ctbs_y
        z4 = lambda dt, shape=(h4, w4): np.zeros(shape, dt)
        self.ct_depth = z4(np.uint8)
        self.cu_pred_mode = z4(np.uint8)
        self.part_mode = z4(np.uint8)
        self.skip_flag = z4(np.uint8)
        self.tq_bypass = z4(np.uint8)
        self.pcm_flag = z4(np.uint8)
        self.intra_mode_y = z4(np.uint8)
        self.intra_mode_c = z4(np.uint8)
        self.mv = np.zeros((2, h4, w4, 2), np.int16)
        self.ref_idx = np.full((2, h4, w4), -1, np.int8)
        self.merge_flag = z4(np.uint8)
        self.merge_idx = z4(np.uint8)
        self.mvd = np.zeros((2, h4, w4, 2), np.int16)
        self.mvp_flag = np.zeros((2, h4, w4), np.uint8)
        self.ref_poc = np.zeros((2, h4, w4), np.int32)
        self.ref_is_lt = np.zeros((2, h4, w4), np.uint8)
        self.qp_y = z4(np.int8)
        self.cu_size_log2 = z4(np.uint8)
        self.pu_id = np.full((h4, w4), -1, np.int32)
        self.cu_id = np.full((h4, w4), -1, np.int32)
        self.tu_log2 = z4(np.uint8)
        self.tu_id = np.full((h4, w4), -1, np.int32)
        self.cbf_y = z4(np.uint8)
        self.cbf_cb = z4(np.uint8)
        self.cbf_cr = z4(np.uint8)
        self.transform_skip_y = z4(np.uint8)
        self.transform_skip_cb = z4(np.uint8)
        self.transform_skip_cr = z4(np.uint8)
        self.slice_idx = np.full((hc, wc), -1, np.int32)
        self.coeff_y = np.zeros((h, w), np.int16)
        cw, ch = w // sps.sub_width_c, h // sps.sub_height_c
        self.coeff_cb = np.zeros((ch, cw), np.int16)
        self.coeff_cr = np.zeros((ch, cw), np.int16)
        self.sao_type = np.zeros((hc, wc, 3), np.uint8)
        self.sao_class = np.zeros((hc, wc, 3), np.uint8)
        self.sao_offsets = np.zeros((hc, wc, 3, 4), np.int8)
        self.sao_merge = np.zeros((hc, wc), np.uint8)
