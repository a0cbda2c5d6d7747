"""CTU-level CABAC syntax parsing -> PicturePlan decision tensors.

Spec clauses 7.3.8 (syntax), 9.3.3 (binarization), 9.3.4 (ctx derivation).
Parity reference: turing/SyntaxCtu.hpp (syntax order), turing/Read.h:462-1124
(CABAC reads), turing/Binarization.h (ctx selection).

The parse is host-side and serial per substream (CABAC is a serial bin
machine) but writes only into dense plan tensors, never into pixels — the
pixel pipeline consumes the plan in batched form on device.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional

import numpy as np

from turingcodec_tpu_torch.cabac.engine import CabacDecoder, ContextPool, ctx_index
from turingcodec_tpu_torch.hevc import types as T
from turingcodec_tpu_torch.hevc.geometry import PictureGeometry
from turingcodec_tpu_torch.hevc.params import Pps, SliceSegmentHeader, Sps
from turingcodec_tpu_torch.hevc.tables import SIG_CTX_4x4, scan_order
from turingcodec_tpu_torch.decode.plan import PicturePlan

# flattened (index, x, y) scan tables cache
_scan_cache = {}


def _scan(log2: int, idx: int) -> np.ndarray:
    key = (log2, idx)
    if key not in _scan_cache:
        _scan_cache[key] = scan_order(log2, idx)
    return _scan_cache[key]


class SliceParseContext:
    """Per-slice parsing state: CABAC engine + WPP snapshots + QP chain."""

    def __init__(self, plan: PicturePlan, geom: PictureGeometry,
                 sh: SliceSegmentHeader, slice_number: int,
                 inter_hook: Optional[Callable] = None):
        self.plan = plan
        self.geom = geom
        self.sps: Sps = plan.sps
        self.pps: Pps = plan.pps
        self.sh = sh
        self.slice_number = slice_number
        self.ctx = ContextPool()
        self.dec: CabacDecoder = None
        self.qp_y_pred = sh.slice_qp_y
        self.qp_y = sh.slice_qp_y
        self.last_cu_qp = sh.slice_qp_y  # QpY of the previous CU (qPY_PREV)
        self.is_cu_qp_delta_coded = False
        self.cu_qp_delta_val = 0
        self.wpp_saved_ctx: Optional[ContextPool] = None
        # cu/pu/tu counters: shared picture-wide via the plan so ids stay
        # unique across slice segments (deblock edge detection compares
        # neighbouring ids; a per-segment reset could collide at segment
        # boundaries and hide a real TU/PU edge)
        if not hasattr(plan, "id_counters"):
            plan.id_counters = [0, 0, 0]
        self.next_id = plan.id_counters
        # inter_hook(ctx, x0, y0, nPbW, nPbH, part_idx, cu_info, pu_syntax)
        # -> fills plan.mv/ref_idx for the PU (mvp/merge derivation lives in
        # decode.mvp to keep this file purely syntactic)
        self.inter_hook = inter_hook
        # transient per-CU info
        self.cu = None

    # --- binarization helpers -------------------------------------------

    def tr_ctx_bypass(self, element: str, c_max: int, num_ctx_bins: int = 1,
                      ctx_incs=None) -> int:
        """Truncated-rice (unary) with first bins context-coded."""
        dec = self.dec
        v = 0
        while v < c_max:
            if v < num_ctx_bins:
                inc = ctx_incs[min(v, len(ctx_incs) - 1)] if ctx_incs else 0
                b = dec.decode_decision(ctx_index(element, inc))
            else:
                b = dec.decode_bypass()
            if not b:
                break
            v += 1
        return v


def parse_sao(ps: SliceParseContext, rx: int, ry: int):
    """sao() syntax (spec 7.3.8.3)."""
    plan, sh, dec = ps.plan, ps.sh, ps.dec
    sps = ps.sps
    merge_left = merge_up = 0
    if rx > 0:
        left_in_slice = plan.slice_idx[ry, rx - 1] == ps.slice_number or (
            sh.slice_loop_filter_across_slices_enabled_flag
            and plan.slice_idx[ry, rx - 1] >= 0)
        same_tile = ps.geom.tile_id[ry, rx] == ps.geom.tile_id[ry, rx - 1]
        if plan.slice_idx[ry, rx - 1] == ps.slice_number and same_tile:
            merge_left = dec.decode_decision(ctx_index("sao_merge_flag"))
    if not merge_left and ry > 0:
        same_tile = ps.geom.tile_id[ry, rx] == ps.geom.tile_id[ry - 1, rx]
        if plan.slice_idx[ry - 1, rx] == ps.slice_number and same_tile:
            merge_up = dec.decode_decision(ctx_index("sao_merge_flag"))
    if merge_left or merge_up:
        sy, sx = (ry, rx - 1) if merge_left else (ry - 1, rx)
        plan.sao_type[ry, rx] = plan.sao_type[sy, sx]
        plan.sao_class[ry, rx] = plan.sao_class[sy, sx]
        plan.sao_offsets[ry, rx] = plan.sao_offsets[sy, sx]
        return
    bit_depth_y = sps.bit_depth_y
    bit_depth_c = sps.bit_depth_c
    for c_idx in range(3 if sps.chroma_array_type else 1):
        if c_idx == 0 and not sh.slice_sao_luma_flag:
            continue
        if c_idx > 0 and not sh.slice_sao_chroma_flag:
            continue
        if c_idx <= 1:
            # sao_type_idx_luma / _chroma: 1 ctx bin + 1 bypass
            t = 0
            if dec.decode_decision(ctx_index("sao_type_idx")):
                t = 2 if dec.decode_bypass() else 1
            plan.sao_type[ry, rx, c_idx] = t
            if c_idx == 1:
                plan.sao_type[ry, rx, 2] = t
        t = plan.sao_type[ry, rx, c_idx]
        if t == 0:
            continue
        bd = bit_depth_y if c_idx == 0 else bit_depth_c
        c_max = (1 << (min(bd, 10) - 5)) - 1
        offsets = []
        for _ in range(4):
            v = 0
            while v < c_max and dec.decode_bypass():
                v += 1
            offsets.append(v)
        if t == 1:  # band
            for i in range(4):
                if offsets[i] and dec.decode_bypass():
                    offsets[i] = -offsets[i]
            plan.sao_class[ry, rx, c_idx] = dec.decode_bypass_bits(5)
        else:  # edge: offsets 0,1 positive; 2,3 negative
            offsets[2] = -offsets[2]
            offsets[3] = -offsets[3]
            if c_idx <= 1:
                eo = dec.decode_bypass_bits(2)
                plan.sao_class[ry, rx, c_idx] = eo
                if c_idx == 1:
                    plan.sao_class[ry, rx, 2] = eo
        plan.sao_offsets[ry, rx, c_idx] = offsets


class CuInfo:
    __slots__ = ("x0", "y0", "log2_size", "pred_mode", "part_mode", "skip",
                 "tq_bypass", "intra_modes_y", "intra_mode_c", "ct_depth",
                 "max_trafo_depth", "intra_split", "cu_id", "tus", "pcm")

    def __init__(self):
        self.intra_modes_y = [1, 1, 1, 1]
        self.intra_mode_c = 1
        self.part_mode = 0
        self.skip = False
        self.tq_bypass = False
        self.intra_split = 0
        self.pred_mode = 0
        self.pcm = False
        self.tus = []  # leaf TUs in decode order:
        # (x0, y0, log2, blk_idx, x_base, y_base, cbf_y, cbf_cb, cbf_cr)


def parse_ctu(ps: SliceParseContext, ctb_addr_rs: int):
    """coding_tree_unit() (spec 7.3.8.2)."""
    sps = ps.sps
    wc = sps.pic_width_in_ctbs_y
    rx, ry = ctb_addr_rs % wc, ctb_addr_rs // wc
    ps.plan.slice_idx[ry, rx] = ps.slice_number
    if ps.sh.slice_sao_luma_flag or ps.sh.slice_sao_chroma_flag:
        parse_sao(ps, rx, ry)
    x0, y0 = rx << sps.ctb_log2_size_y, ry << sps.ctb_log2_size_y
    parse_coding_quadtree(ps, x0, y0, sps.ctb_log2_size_y, 0)


def parse_coding_quadtree(ps: SliceParseContext, x0: int, y0: int,
                          log2_size: int, depth: int):
    sps, pps, dec, plan = ps.sps, ps.pps, ps.dec, ps.plan
    w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
    in_pic = x0 + (1 << log2_size) <= w and y0 + (1 << log2_size) <= h
    split = log2_size > sps.min_cb_log2_size_y
    if in_pic and log2_size > sps.min_cb_log2_size_y:
        # split_cu_flag ctx: neighbours deeper than current depth
        inc = 0
        if ps.geom.available(plan.slice_idx, x0, y0, x0 - 1, y0):
            inc += int(plan.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth)
        if ps.geom.available(plan.slice_idx, x0, y0, x0, y0 - 1):
            inc += int(plan.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth)
        split = bool(dec.decode_decision(ctx_index("split_cu_flag", inc)))
    if pps.cu_qp_delta_enabled_flag and log2_size >= (
            sps.ctb_log2_size_y - pps.diff_cu_qp_delta_depth):
        ps.is_cu_qp_delta_coded = False
        ps.cu_qp_delta_val = 0
        # qPY_PREV = QpY of the last CU of the previous QG (spec 8.6.1)
        ps.qp_y_pred = ps.last_cu_qp
    if split:
        half = 1 << (log2_size - 1)
        x1, y1 = x0 + half, y0 + half
        parse_coding_quadtree(ps, x0, y0, log2_size - 1, depth + 1)
        if x1 < w:
            parse_coding_quadtree(ps, x1, y0, log2_size - 1, depth + 1)
        if y1 < h:
            parse_coding_quadtree(ps, x0, y1, log2_size - 1, depth + 1)
        if x1 < w and y1 < h:
            parse_coding_quadtree(ps, x1, y1, log2_size - 1, depth + 1)
    else:
        parse_coding_unit(ps, x0, y0, log2_size, depth)
        # per-CU QpY (reference QpState semantics): derived at THIS CU's
        # parse with the CuQpDeltaVal state as of now — CUs of a group
        # parsed before the delta keep pred + 0, NOT the later delta
        qp = _derive_qp(ps, x0, y0)
        size = 1 << log2_size
        ps.plan.qp_y[y0 >> 2:(y0 + size) >> 2,
                     x0 >> 2:(x0 + size) >> 2] = qp
        ps.last_cu_qp = qp


def _set_block(arr: np.ndarray, x0: int, y0: int, size: int, w: int = None,
               h: int = None, value=0):
    arr[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = value


def parse_coding_unit(ps: SliceParseContext, x0: int, y0: int,
                      log2_size: int, depth: int):
    """coding_unit() (spec 7.3.8.5)."""
    sps, pps, dec, plan, sh = ps.sps, ps.pps, ps.dec, ps.plan, ps.sh
    size = 1 << log2_size
    cu = CuInfo()
    cu.x0, cu.y0, cu.log2_size, cu.ct_depth = x0, y0, log2_size, depth
    cu.cu_id = ps.next_id[0]
    ps.next_id[0] += 1
    ps.cu = cu
    plan.cu_list.append(cu)
    b = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
    plan.ct_depth[b] = depth
    plan.cu_size_log2[b] = log2_size
    plan.cu_id[b] = cu.cu_id

    if pps.transquant_bypass_enabled_flag:
        cu.tq_bypass = bool(dec.decode_decision(
            ctx_index("cu_transquant_bypass_flag")))
        plan.tq_bypass[b] = cu.tq_bypass

    skip = False
    if not sh.is_i:
        inc = 0
        if ps.geom.available(plan.slice_idx, x0, y0, x0 - 1, y0):
            inc += int(plan.skip_flag[y0 >> 2, (x0 - 1) >> 2])
        if ps.geom.available(plan.slice_idx, x0, y0, x0, y0 - 1):
            inc += int(plan.skip_flag[(y0 - 1) >> 2, x0 >> 2])
        skip = bool(dec.decode_decision(ctx_index("cu_skip_flag", inc)))
    cu.skip = skip
    plan.skip_flag[b] = skip

    if skip:
        cu.pred_mode = 0
        plan.cu_pred_mode[b] = 0
        plan.qp_y[b] = _derive_qp(ps, x0, y0)
        prediction_unit(ps, x0, y0, size, size, 0, 1, merge_only=True)
        plan.tu_log2[b] = min(log2_size, sps.max_tb_log2_size_y)
        return

    pred_intra = True
    if not sh.is_i:
        pred_intra = bool(dec.decode_decision(ctx_index("pred_mode_flag")))
    cu.pred_mode = 1 if pred_intra else 0
    plan.cu_pred_mode[b] = cu.pred_mode

    part_mode = 0
    pcm = False
    if pred_intra:
        if log2_size == sps.min_cb_log2_size_y and not dec.decode_decision(
                ctx_index("part_mode", 0)):
            part_mode = T.PART_NxN
    else:
        part_mode = _parse_inter_part_mode(ps, log2_size)
    cu.part_mode = part_mode
    plan.part_mode[b] = part_mode

    if pred_intra:
        if (sps.pcm_enabled_flag and part_mode == 0
                and log2_size >= sps.log2_min_pcm_luma_coding_block_size_minus3 + 3
                and log2_size <= (sps.log2_min_pcm_luma_coding_block_size_minus3
                                  + 3 + sps.log2_diff_max_min_pcm_luma_coding_block_size)):
            pcm = bool(dec.decode_terminate())
        if pcm:
            cu.pcm = True
            _parse_pcm(ps, x0, y0, log2_size)
            plan.pcm_flag[b] = 1
            plan.qp_y[b] = _derive_qp(ps, x0, y0)
            return
        _parse_intra_modes(ps, cu)
    else:
        n_parts = {T.PART_2Nx2N: 1, T.PART_NxN: 4}.get(part_mode, 2)
        _parse_inter_pus(ps, cu, part_mode)

    # transform tree
    rqt_root = True
    if not pred_intra and not (part_mode == T.PART_2Nx2N and _last_merge(ps)):
        rqt_root = bool(dec.decode_decision(ctx_index("rqt_root_cbf")))
    plan.qp_y[b] = _derive_qp(ps, x0, y0)  # provisional; updated on dQP parse
    if rqt_root:
        max_depth = (sps.max_transform_hierarchy_depth_intra + cu.intra_split
                     if pred_intra else sps.max_transform_hierarchy_depth_inter)
        cu.max_trafo_depth = max_depth
        parse_transform_tree(ps, x0, y0, x0, y0, log2_size, 0, 0,
                             cbf_cb=[1, 1], cbf_cr=[1, 1])
    else:
        plan.tu_log2[b] = min(log2_size, sps.max_tb_log2_size_y)


def _last_merge(ps) -> bool:
    return getattr(ps, "_last_pu_was_merge", False)


def _parse_inter_part_mode(ps: SliceParseContext, log2_size: int) -> int:
    """part_mode binarization for inter CUs (spec 9.3.3.7)."""
    dec, sps = ps.dec, ps.sps
    if dec.decode_decision(ctx_index("part_mode", 0)):
        return T.PART_2Nx2N
    at_min = log2_size == sps.min_cb_log2_size_y
    amp = sps.amp_enabled_flag and not at_min
    b1 = dec.decode_decision(ctx_index("part_mode", 1))
    if at_min:
        if b1:
            return T.PART_2NxN
        if log2_size == 3:
            return T.PART_Nx2N
        # 8x8 CUs cannot be NxN inter when size 8 (min CB 8): NxN only if
        # log2 > 3; bin2 distinguishes Nx2N / NxN
        if dec.decode_decision(ctx_index("part_mode", 2)):
            return T.PART_Nx2N
        return T.PART_NxN
    if not amp:
        return T.PART_2NxN if b1 else T.PART_Nx2N
    # AMP: bin2 ctx part_mode[3]; bin3 bypass
    b2 = dec.decode_decision(ctx_index("part_mode", 3))
    if b1:
        if b2:
            return T.PART_2NxN
        return T.PART_2NxnD if dec.decode_bypass() else T.PART_2NxnU
    if b2:
        return T.PART_Nx2N
    return T.PART_nRx2N if dec.decode_bypass() else T.PART_nLx2N


def _parse_pcm(ps: SliceParseContext, x0: int, y0: int, log2_size: int):
    dec, sps, plan = ps.dec, ps.sps, ps.plan
    size = 1 << log2_size
    # After a terminate bin with value 1, the continuation bit position is
    # (bits consumed - 1): the CABAC flush's final '1' doubles as the
    # alignment bit (reference: Read.h:647 reader.rewind(-bitsNeeded)).
    bd_y = sps.pcm_sample_bit_depth_luma_minus1 + 1
    bd_c = sps.pcm_sample_bit_depth_chroma_minus1 + 1
    from turingcodec_tpu_torch.bitstream.reader import BitReader
    br = BitReader(dec.data)
    br.pos = dec.pos - 1
    br.byte_alignment()  # flush '1' + pcm_alignment_zero_bits
    ys = np.zeros((size, size), np.int32)
    for yy in range(size):
        for xx in range(size):
            ys[yy, xx] = br.u(bd_y) << (sps.bit_depth_y - bd_y)
    cs = size >> 1
    cbs = np.zeros((cs, cs), np.int32)
    crs = np.zeros((cs, cs), np.int32)
    if sps.chroma_array_type:
        for plane in (cbs, crs):
            for yy in range(cs):
                for xx in range(cs):
                    plane[yy, xx] = br.u(bd_c) << (sps.bit_depth_c - bd_c)
    ps.plan.pcm_samples.append((x0, y0, log2_size, ys, cbs, crs))
    # restart CABAC engine immediately after the PCM payload (byte aligned)
    assert br.pos % 8 == 0
    ps.dec = CabacDecoder(dec.data, br.pos, ps.ctx)


def _parse_intra_modes(ps: SliceParseContext, cu: CuInfo):
    """Intra luma (MPM) + chroma mode parse & derivation (spec 8.4.2/8.4.3)."""
    dec, plan, sps = ps.dec, ps.plan, ps.sps
    n = 1 if cu.part_mode == T.PART_2Nx2N else 4
    cu.intra_split = 0 if n == 1 else 1
    pb = 1 << (cu.log2_size - (0 if n == 1 else 1))
    prev_flags = [dec.decode_decision(ctx_index("prev_intra_luma_pred_flag"))
                  for _ in range(n)]
    modes = []
    for i in range(n):
        xb = cu.x0 + (i & 1) * pb
        yb = cu.y0 + (i >> 1) * pb
        cands = _intra_mpm(ps, xb, yb)
        if prev_flags[i]:
            # mpm_idx: TR cMax 2, all bypass
            idx = 0
            if dec.decode_bypass():
                idx = 2 if dec.decode_bypass() else 1
            mode = cands[idx]
        else:
            rem = dec.decode_bypass_bits(5)
            for c in sorted(cands):
                if rem >= c:
                    rem += 1
            mode = rem
        modes.append(mode)
        plan.intra_mode_y[yb >> 2:(yb + pb) >> 2, xb >> 2:(xb + pb) >> 2] = mode
    cu.intra_modes_y = modes
    # chroma (4:2:0: single mode for CU)
    if sps.chroma_array_type in (1, 2):
        if dec.decode_decision(ctx_index("intra_chroma_pred_mode")):
            idx = dec.decode_bypass_bits(2)
            cand = [0, 26, 10, 1]
            mode_c = cand[idx]
            if mode_c == modes[0]:
                mode_c = 34
        else:
            mode_c = modes[0]  # derived (DM)
        cu.intra_mode_c = mode_c
        size = 1 << cu.log2_size
        plan.intra_mode_c[cu.y0 >> 2:(cu.y0 + size) >> 2,
                          cu.x0 >> 2:(cu.x0 + size) >> 2] = mode_c


def _intra_mpm_n(ps: SliceParseContext, xb: int, yb: int):
    """candModeList derivation (spec 8.4.2); also returns the number of
    neighbour-derived entries (CandModeList.neighbourModes: 1 when the two
    neighbour modes agree, else 2)."""
    plan = ps.plan
    ctb_log2 = ps.sps.ctb_log2_size_y

    def cand(x_nb, y_nb, is_above):
        if not ps.geom.available(plan.slice_idx, xb, yb, x_nb, y_nb):
            return 1  # DC
        if plan.cu_pred_mode[y_nb >> 2, x_nb >> 2] != 1:
            return 1
        if plan.pcm_flag[y_nb >> 2, x_nb >> 2]:
            return 1
        if is_above and (y_nb >> ctb_log2) != (yb >> ctb_log2):
            return 1  # above outside current CTB row
        return int(plan.intra_mode_y[y_nb >> 2, x_nb >> 2])

    a = cand(xb - 1, yb, False)
    b = cand(xb, yb - 1, True)
    if a == b:
        if a < 2:
            return [0, 1, 26], 1
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)], 1
    c = 0 if (a != 0 and b != 0) else (1 if (a != 1 and b != 1) else 26)
    return [a, b, c], 2


def _intra_mpm(ps: SliceParseContext, xb: int, yb: int) -> List[int]:
    return _intra_mpm_n(ps, xb, yb)[0]


def _parse_inter_pus(ps: SliceParseContext, cu: CuInfo, part_mode: int):
    x0, y0 = cu.x0, cu.y0
    s = 1 << cu.log2_size
    h = s >> 1
    q = s >> 2
    geo = {
        T.PART_2Nx2N: [(x0, y0, s, s)],
        T.PART_2NxN: [(x0, y0, s, h), (x0, y0 + h, s, h)],
        T.PART_Nx2N: [(x0, y0, h, s), (x0 + h, y0, h, s)],
        T.PART_NxN: [(x0, y0, h, h), (x0 + h, y0, h, h),
                     (x0, y0 + h, h, h), (x0 + h, y0 + h, h, h)],
        T.PART_2NxnU: [(x0, y0, s, q), (x0, y0 + q, s, s - q)],
        T.PART_2NxnD: [(x0, y0, s, s - q), (x0, y0 + s - q, s, q)],
        T.PART_nLx2N: [(x0, y0, q, s), (x0 + q, y0, s - q, s)],
        T.PART_nRx2N: [(x0, y0, s - q, s), (x0 + s - q, y0, q, s)],
    }[part_mode]
    for i, (px, py, pw, ph) in enumerate(geo):
        prediction_unit(ps, px, py, pw, ph, i, len(geo))


def prediction_unit(ps: SliceParseContext, x0: int, y0: int, w: int, h: int,
                    part_idx: int, n_parts: int, merge_only: bool = False):
    """prediction_unit() syntax (spec 7.3.8.6) + PU plan fill via inter_hook."""
    dec, sh, plan = ps.dec, ps.sh, ps.plan
    pu_syntax = {"merge": False, "merge_idx": 0, "inter_pred_idc": 1,
                 "ref_idx": [0, 0], "mvd": [(0, 0), (0, 0)],
                 "mvp_flag": [0, 0]}
    if merge_only:
        pu_syntax["merge"] = True
        if sh.max_num_merge_cand > 1:
            pu_syntax["merge_idx"] = _parse_merge_idx(ps)
        ps._last_pu_was_merge = True
    else:
        merge = bool(dec.decode_decision(ctx_index("merge_flag")))
        pu_syntax["merge"] = merge
        ps._last_pu_was_merge = merge
        if merge:
            if sh.max_num_merge_cand > 1:
                pu_syntax["merge_idx"] = _parse_merge_idx(ps)
        else:
            ipi = 1  # PRED_L0
            if sh.is_b:
                ipi = _parse_inter_pred_idc(ps, w, h)
            pu_syntax["inter_pred_idc"] = ipi
            # 1 = L0, 2 = L1, 3 = BI
            for lx in (0, 1):
                if not (ipi & (1 << lx)):
                    continue
                nref = (sh.num_ref_idx_l0_active_minus1 if lx == 0
                        else sh.num_ref_idx_l1_active_minus1)
                if nref > 0:
                    pu_syntax["ref_idx"][lx] = ps.tr_ctx_bypass(
                        "ref_idx", nref, 2, [0, 1])
                if lx == 1 and sh.mvd_l1_zero_flag and ipi == 3:
                    pu_syntax["mvd"][lx] = (0, 0)
                else:
                    pu_syntax["mvd"][lx] = _parse_mvd(ps)
                pu_syntax["mvp_flag"][lx] = dec.decode_decision(
                    ctx_index("mvp_flag"))
    pu_id = ps.next_id[1]
    ps.next_id[1] += 1
    reg = (slice(y0 >> 2, (y0 + h) >> 2), slice(x0 >> 2, (x0 + w) >> 2))
    plan.pu_id[reg] = pu_id
    plan.merge_flag[reg] = int(pu_syntax["merge"])
    plan.merge_idx[reg] = pu_syntax["merge_idx"]
    for lx in (0, 1):
        plan.mvd[(lx,) + reg] = pu_syntax["mvd"][lx]
        plan.mvp_flag[(lx,) + reg] = pu_syntax["mvp_flag"][lx]
    if ps.inter_hook is not None:
        ps.inter_hook(ps, x0, y0, w, h, part_idx, n_parts, pu_syntax)


def _parse_merge_idx(ps: SliceParseContext) -> int:
    dec, sh = ps.dec, ps.sh
    c_max = sh.max_num_merge_cand - 1
    if not dec.decode_decision(ctx_index("merge_idx")):
        return 0
    v = 1
    while v < c_max and dec.decode_bypass():
        v += 1
    return v


def _parse_inter_pred_idc(ps: SliceParseContext, w: int, h: int) -> int:
    """Returns 1 (L0), 2 (L1) or 3 (BI) (spec 9.3.3.x Table 9-36)."""
    dec = ps.dec
    if w + h != 12:
        if dec.decode_decision(ctx_index("inter_pred_idc", ps.cu.ct_depth)):
            return 3
    return 2 if dec.decode_decision(ctx_index("inter_pred_idc", 4)) else 1


def _parse_mvd(ps: SliceParseContext):
    """mvd_coding() (spec 7.3.8.9)."""
    dec = ps.dec
    gx0 = dec.decode_decision(ctx_index("abs_mvd_greater0_flag"))
    gy0 = dec.decode_decision(ctx_index("abs_mvd_greater0_flag"))
    gx1 = dec.decode_decision(ctx_index("abs_mvd_greater1_flag")) if gx0 else 0
    gy1 = dec.decode_decision(ctx_index("abs_mvd_greater1_flag")) if gy0 else 0
    out = []
    for g0, g1 in ((gx0, gx1), (gy0, gy1)):
        v = 0
        if g0:
            v = 1
            if g1:
                v = 2 + dec.decode_egk_bypass(1)
            if dec.decode_bypass():
                v = -v
        out.append(v)
    return tuple(out)


def _derive_qp(ps: SliceParseContext, x0: int, y0: int) -> int:
    """QpY derivation (spec 8.6.1). With dQP disabled this is SliceQpY."""
    if not ps.pps.cu_qp_delta_enabled_flag:
        return ps.sh.slice_qp_y
    sps, plan = ps.sps, ps.plan
    log2_min_qg = sps.ctb_log2_size_y - ps.pps.diff_cu_qp_delta_depth
    mask = ~((1 << log2_min_qg) - 1)
    x_qg, y_qg = x0 & mask, y0 & mask
    ctb_mask = ~((1 << sps.ctb_log2_size_y) - 1)

    def qpa(x_nb, y_nb):
        if not ps.geom.available(plan.slice_idx, x_qg, y_qg, x_nb, y_nb):
            return None
        if (x_nb & ctb_mask, y_nb & ctb_mask) != (x_qg & ctb_mask, y_qg & ctb_mask):
            return None
        return int(plan.qp_y[y_nb >> 2, x_nb >> 2])

    a = qpa(x_qg - 1, y_qg)
    bq = qpa(x_qg, y_qg - 1)
    prev = ps.qp_y_pred
    a = prev if a is None else a
    bq = prev if bq is None else bq
    qp_pred = (a + bq + 1) >> 1
    qp = ((qp_pred + ps.cu_qp_delta_val + 52 + 2 * sps.qp_bd_offset_y)
          % (52 + sps.qp_bd_offset_y)) - sps.qp_bd_offset_y
    return qp


def parse_transform_tree(ps: SliceParseContext, x0: int, y0: int,
                         x_base: int, y_base: int, log2_size: int,
                         trafo_depth: int, blk_idx: int,
                         cbf_cb, cbf_cr):
    """transform_tree() (spec 7.3.8.8). cbf_cb/cbf_cr are [cur, parent_second]
    for 4:2:2; here lists [depth_value] semantics: pass parent cbf values."""
    sps, pps, dec, plan, cu = ps.sps, ps.pps, ps.dec, ps.plan, ps.cu
    max_log2 = sps.max_tb_log2_size_y
    min_log2 = sps.min_tb_log2_size_y
    intra_split = cu.pred_mode == 1 and cu.part_mode == T.PART_NxN

    if (log2_size <= max_log2 and log2_size > min_log2
            and trafo_depth < cu.max_trafo_depth
            and not (intra_split and trafo_depth == 0)):
        split = bool(dec.decode_decision(
            ctx_index("split_transform_flag", 5 - log2_size)))
    else:
        inter_split = (sps.max_transform_hierarchy_depth_inter == 0
                       and cu.pred_mode == 0
                       and cu.part_mode != T.PART_2Nx2N
                       and trafo_depth == 0)
        split = (log2_size > max_log2
                 or (intra_split and trafo_depth == 0)
                 or inter_split)

    chroma_here = log2_size > 2  # 4:2:0: chroma TBs at log2>=2 follow luma>4x4
    parent_cb, parent_cr = cbf_cb, cbf_cr
    my_cbf_cb, my_cbf_cr = parent_cb, parent_cr
    if sps.chroma_array_type and chroma_here:
        if trafo_depth == 0 or parent_cb:
            my_cbf_cb = dec.decode_decision(ctx_index("cbf_chroma", trafo_depth))
        else:
            my_cbf_cb = 0
        if trafo_depth == 0 or parent_cr:
            my_cbf_cr = dec.decode_decision(ctx_index("cbf_chroma", trafo_depth))
        else:
            my_cbf_cr = 0

    if split:
        half = 1 << (log2_size - 1)
        for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half), (half, half))):
            parse_transform_tree(ps, x0 + dx, y0 + dy, x0, y0,
                                 log2_size - 1, trafo_depth + 1, i,
                                 my_cbf_cb, my_cbf_cr)
        return

    # leaf: cbf_luma
    if cu.pred_mode == 1 or trafo_depth != 0 or my_cbf_cb or my_cbf_cr:
        cbf_luma = dec.decode_decision(
            ctx_index("cbf_luma", 1 if trafo_depth == 0 else 0))
    else:
        cbf_luma = 1
    size = 1 << log2_size
    bl = (slice(y0 >> 2, (y0 + size) >> 2), slice(x0 >> 2, (x0 + size) >> 2))
    plan.tu_log2[bl] = log2_size
    tu_id = ps.next_id[2]
    ps.next_id[2] += 1
    plan.tu_id[bl] = tu_id
    plan.cbf_y[bl] = cbf_luma
    if chroma_here:
        plan.cbf_cb[bl] = my_cbf_cb
        plan.cbf_cr[bl] = my_cbf_cr
    else:
        # 4x4 luma: chroma carried at parent 8x8 when blk_idx==3
        if blk_idx == 3:
            pb = (slice(y_base >> 2, (y_base + 2 * size) >> 2),
                  slice(x_base >> 2, (x_base + 2 * size) >> 2))
            plan.cbf_cb[pb] = parent_cb
            plan.cbf_cr[pb] = parent_cr
    cu.tus.append((x0, y0, log2_size, blk_idx, x_base, y_base,
                   int(cbf_luma), int(my_cbf_cb), int(my_cbf_cr)))
    parse_transform_unit(ps, x0, y0, x_base, y_base, log2_size, trafo_depth,
                         blk_idx, cbf_luma, my_cbf_cb, my_cbf_cr)


def parse_transform_unit(ps: SliceParseContext, x0, y0, x_base, y_base,
                         log2_size, trafo_depth, blk_idx,
                         cbf_luma, cbf_cb, cbf_cr):
    """transform_unit() (spec 7.3.8.10)."""
    sps, pps, dec, plan, cu, sh = ps.sps, ps.pps, ps.dec, ps.plan, ps.cu, ps.sh
    chroma_last = log2_size == 2 and blk_idx == 3
    any_chroma = (cbf_cb or cbf_cr) and (log2_size > 2 or chroma_last)
    # spec 7.3.8.10: the transform_unit body (and with it cu_qp_delta)
    # is entered when ANY of cbf_luma/cbf_cb/cbf_cr is set — at 4x4 TUs
    # the chroma cbfs are the PARENT's, so the delta can appear at
    # blkIdx 0 of a chroma-only group; the chroma residual itself still
    # rides blkIdx 3
    if cbf_luma or cbf_cb or cbf_cr:
        if pps.cu_qp_delta_enabled_flag and not ps.is_cu_qp_delta_coded:
            # cu_qp_delta_abs: TR prefix (cMax 5, ctx [0, 1...]), EG0 suffix
            prefix = ps.tr_ctx_bypass("cu_qp_delta_abs", 5, 5, [0, 1, 1, 1, 1])
            val = prefix
            if prefix == 5:
                val = 5 + dec.decode_egk_bypass(0)
            if val and dec.decode_bypass():
                val = -val
            ps.is_cu_qp_delta_coded = True
            ps.cu_qp_delta_val = val
        if cbf_luma:
            parse_residual_coding(ps, x0, y0, log2_size, 0)
        if any_chroma:
            if log2_size > 2:
                if cbf_cb:
                    parse_residual_coding(ps, x0 >> 1, y0 >> 1,
                                          log2_size - 1, 1)
                if cbf_cr:
                    parse_residual_coding(ps, x0 >> 1, y0 >> 1,
                                          log2_size - 1, 2)
            else:
                if cbf_cb:
                    parse_residual_coding(ps, x_base >> 1, y_base >> 1,
                                          log2_size, 1)
                if cbf_cr:
                    parse_residual_coding(ps, x_base >> 1, y_base >> 1,
                                          log2_size, 2)
    # (qPY_PREV updates happen per CU via last_cu_qp)


def parse_residual_coding(ps: SliceParseContext, x0: int, y0: int,
                          log2_size: int, c_idx: int):
    """residual_coding() (spec 7.3.8.11) -> coefficient plane.

    Coordinates are in the plane's own sample units (chroma halved).
    """
    sps, pps, dec, plan, cu = ps.sps, ps.pps, ps.dec, ps.plan, ps.cu
    sh = ps.sh

    ts_flag = 0
    if (pps.transform_skip_enabled_flag and not cu.tq_bypass
            and log2_size == 2):
        el = "transform_skip_flag_luma" if c_idx == 0 else "transform_skip_flag_chroma"
        ts_flag = dec.decode_decision(ctx_index(el))
        if c_idx == 0:
            plan.transform_skip_y[y0 >> 2, x0 >> 2] = ts_flag
        elif c_idx == 1:
            plan.transform_skip_cb[y0 >> 1, x0 >> 1] = ts_flag
        else:
            plan.transform_skip_cr[y0 >> 1, x0 >> 1] = ts_flag

    # scan selection (spec 7.4.9.11)
    scan_idx = 0
    if cu.pred_mode == 1 and (log2_size == 2 or (log2_size == 3 and c_idx == 0)):
        if c_idx == 0:
            mode = int(plan.intra_mode_y[(y0 >> 2), (x0 >> 2)])
        else:
            mode = int(plan.intra_mode_c[(y0 << 1) >> 2, (x0 << 1) >> 2])
        if 6 <= mode <= 14:
            scan_idx = 2  # vertical
        elif 22 <= mode <= 30:
            scan_idx = 1  # horizontal

    if c_idx == 0:
        coeff_plane = plan.coeff_y
    elif c_idx == 1:
        coeff_plane = plan.coeff_cb
    else:
        coeff_plane = plan.coeff_cr
    sdh = (pps.sign_data_hiding_enabled_flag and not cu.tq_bypass)

    # native (C++) hot path for everything from the last-position syntax down
    from turingcodec_tpu_torch import native
    blk = native.residual_decode(dec, log2_size, c_idx, scan_idx, sdh)
    if blk is not None:
        n = 1 << log2_size
        coeff_plane[y0:y0 + n, x0:x0 + n] = blk
        return

    # last position
    def last_prefix(element):
        c_max = (log2_size << 1) - 1
        if c_idx == 0:
            ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
            ctx_shift = (log2_size + 1) >> 2
        else:
            ctx_off = 15
            ctx_shift = log2_size - 2
        v = 0
        while v < c_max and dec.decode_decision(
                ctx_index(element, (v >> ctx_shift) + ctx_off)):
            v += 1
        return v

    px = last_prefix("last_sig_coeff_x_prefix")
    py = last_prefix("last_sig_coeff_y_prefix")
    if px > 3:
        n = (px >> 1) - 1
        last_x = (1 << n) * (2 + (px & 1)) + dec.decode_bypass_bits(n)
    else:
        last_x = px
    if py > 3:
        n = (py >> 1) - 1
        last_y = (1 << n) * (2 + (py & 1)) + dec.decode_bypass_bits(n)
    else:
        last_y = py
    if scan_idx == 2:
        last_x, last_y = last_y, last_x

    sub_scan = _scan(log2_size - 2, scan_idx)  # subblock grid scan
    pos_scan = _scan(2, scan_idx)              # within-subblock 4x4 scan
    n_sub = 1 << (2 * (log2_size - 2))

    # locate last: subblock + position
    sub_of_last = None
    pos_of_last = None
    lx_s, ly_s = last_x >> 2, last_y >> 2
    for i in range(n_sub):
        if sub_scan[i, 0] == lx_s and sub_scan[i, 1] == ly_s:
            sub_of_last = i
            break
    lx_p, ly_p = last_x & 3, last_y & 3
    for i in range(16):
        if pos_scan[i, 0] == lx_p and pos_scan[i, 1] == ly_p:
            pos_of_last = i
            break

    csbf = np.zeros((1 << (log2_size - 2), 1 << (log2_size - 2)), np.uint8)
    c1_chain_gt1 = 0  # previous subblock had a greater1

    for i in range(sub_of_last, -1, -1):
        xs, ys = int(sub_scan[i, 0]), int(sub_scan[i, 1])
        infer_sb_dc = 0
        if i < sub_of_last and i > 0:
            inc = int(bool((xs + 1 < csbf.shape[1] and csbf[ys, xs + 1])
                           or (ys + 1 < csbf.shape[0] and csbf[ys + 1, xs])))
            sb_coded = dec.decode_decision(
                ctx_index("coded_sub_block_flag", inc + (2 if c_idx else 0)))
            infer_sb_dc = 1
        else:
            sb_coded = 1
        csbf[ys, xs] = sb_coded
        if not sb_coded:
            continue

        # significant flags (reverse scan within subblock)
        start_n = pos_of_last - 1 if i == sub_of_last else 15
        sig = np.zeros(16, np.uint8)
        if i == sub_of_last:
            sig[pos_of_last] = 1
        prev_csbf = 0
        if xs + 1 < csbf.shape[1] and csbf[ys, xs + 1]:
            prev_csbf += 1
        if ys + 1 < csbf.shape[0] and csbf[ys + 1, xs]:
            prev_csbf += 2
        sctx16 = _sig_ctx16(log2_size, c_idx, scan_idx, xs, ys, prev_csbf)
        for n in range(start_n, -1, -1):
            if n > 0 or not infer_sb_dc:
                b = dec.decode_decision(sctx16[n])
                sig[n] = b
                if b:
                    infer_sb_dc = 0
            else:
                sig[n] = 1

        sig_pos = [n for n in range(15, -1, -1) if sig[n]]  # reverse scan order
        if not sig_pos:
            continue

        # greater1 flags: first 8 sig coeffs
        ctx_set = (0 if (i == 0 or c_idx > 0) else 2) + (1 if c1_chain_gt1 else 0)
        c1 = 1
        c1_chain_gt1 = 0
        gt1 = {}
        first_gt1_pos = -1
        for k, n in enumerate(sig_pos[:8]):
            inc = ctx_set * 4 + c1
            b = dec.decode_decision(
                ctx_index("coeff_abs_level_greater1_flag",
                          inc + (16 if c_idx else 0)))
            gt1[n] = b
            if b:
                c1 = 0
                c1_chain_gt1 = 1
                if first_gt1_pos < 0:
                    first_gt1_pos = n
            elif 0 < c1 < 3:
                c1 += 1
        gt2 = {}
        if first_gt1_pos >= 0:
            b = dec.decode_decision(
                ctx_index("coeff_abs_level_greater2_flag",
                          ctx_set + (4 if c_idx else 0)))
            gt2[first_gt1_pos] = b

        # signs
        first_sig_scan = sig_pos[-1]
        last_sig_scan = sig_pos[0]
        sign_hidden = sdh and (last_sig_scan - first_sig_scan > 3)
        signs = {}
        for n in sig_pos:
            if sign_hidden and n == first_sig_scan:
                continue
            signs[n] = dec.decode_bypass()

        # remaining levels
        rice = 0
        base_sum = 0
        num_gt1_coded = 0
        levels = {}
        for k, n in enumerate(sig_pos):
            base = 1
            if k < 8:
                base += gt1.get(n, 0)
                if n == first_gt1_pos:
                    base += gt2.get(n, 0)
            # remaining present when level may exceed what flags encode
            need_rem = False
            if k < 8:
                if n == first_gt1_pos and gt2.get(n, 0):
                    need_rem = True
                elif gt1.get(n, 0) and n != first_gt1_pos:
                    need_rem = True
                elif k >= 8:
                    need_rem = True
            else:
                need_rem = True
            level = base
            if need_rem:
                rem = _decode_remaining(dec, rice)
                level = base + rem
                if level > (3 << rice):
                    rice = min(rice + 1, 4)
            levels[n] = level

        # place coefficients
        sum_abs = sum(levels.values())
        for n in sig_pos:
            xc = x0 + (xs << 2) + int(pos_scan[n, 0])
            yc = y0 + (ys << 2) + int(pos_scan[n, 1])
            lv = levels[n]
            if sign_hidden and n == first_sig_scan:
                neg = (sum_abs & 1)
            else:
                neg = signs.get(n, 0)
            coeff_plane[yc, xc] = -lv if neg else lv


@functools.lru_cache(maxsize=None)
def _sig_ctx16(log2_size, c_idx, scan_idx, xs, ys, prev_csbf):
    """Full sig_coeff_flag context indices (CONTEXT_OFFSET included) for all
    16 scan positions of subblock (xs, ys) — the per-coefficient ctx is fully
    determined by these keys, so both parser and writer share one cached
    table per subblock instead of recomputing per coefficient."""
    pos_scan = _scan(2, scan_idx)
    out = []
    for nn in range(16):
        xp, yp = int(pos_scan[nn, 0]), int(pos_scan[nn, 1])
        xc, yc = (xs << 2) + xp, (ys << 2) + yp
        out.append(ctx_index("sig_coeff_flag",
                             _sig_ctx(log2_size, c_idx, scan_idx, xc, yc,
                                      xp, yp, xs, ys, prev_csbf)))
    return tuple(out)


def _sig_ctx(log2_size, c_idx, scan_idx, xc, yc, xp, yp, xs, ys, prev_csbf):
    """sig_coeff_flag ctxInc (spec 9.3.4.2.5)."""
    if log2_size == 2:
        sig = int(SIG_CTX_4x4[(yp << 2) + xp])
    elif xc == 0 and yc == 0:
        sig = 0
    else:
        if prev_csbf == 0:
            s = xp + yp
            sig = 2 if s == 0 else (1 if s < 3 else 0)
        elif prev_csbf == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev_csbf == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if xs or ys:
                sig += 3
            sig += 9 if (log2_size == 3 and scan_idx == 0) else (
                15 if log2_size == 3 else 21)
        else:
            sig += 9 if log2_size == 3 else 12
    return sig + (27 if c_idx else 0)


def _decode_remaining(dec: CabacDecoder, rice: int) -> int:
    """coeff_abs_level_remaining (spec 9.3.3.13): TR prefix + EG suffix."""
    prefix = 0
    while prefix < 32 and dec.decode_bypass():
        prefix += 1
    if prefix <= 3:
        return (prefix << rice) + (dec.decode_bypass_bits(rice) if rice else 0)
    n = prefix - 3 + rice
    return dec.decode_bypass_bits(n) + (((1 << (prefix - 3)) + 2) << rice)
