"""Encoder facade: configuration -> parameter sets, frame loop, NAL/AU
assembly. Parity reference: turing/Encoder.cpp (setupSps/Pps/Vps 576-973,
encodePicture 422), turing/TaskEncodeOutput.cpp (AU assembly).

Round-1 scope: all-intra, fixed QP, IDR-only, single slice, no WPP.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from turingcodec_tpu_torch.bitstream.writer import BitWriter, wrap_nal
from turingcodec_tpu_torch.hevc import types as T
from turingcodec_tpu_torch.hevc.geometry import PictureGeometry
from turingcodec_tpu_torch.hevc.header_syntax import (
    write_pps,
    write_slice_segment_header,
    write_sps,
    write_vps,
)
from turingcodec_tpu_torch.hevc.params import (
    Pps,
    ProfileTierLevel,
    SliceSegmentHeader,
    Sps,
    Vps,
)
from turingcodec_tpu_torch.encode.ctu_write import write_slice_data
from turingcodec_tpu_torch.encode.intra_search import IntraPictureEncoder
from turingcodec_tpu_torch.decode.picture_recon import PictureReconstructor


@dataclass
class EncoderConfig:
    width: int = 640
    height: int = 360
    qp: int = 26
    bit_depth: int = 8
    ctb_log2: int = 6
    min_cb_log2: int = 3
    rd_candidates: int = 3
    max_cu_log2: int = 5
    intra_period: int = 0   # 0 = only first frame is IDR
    all_intra: bool = False
    gop_m: int = 1          # 1 = low-delay P; 2/4/8 = hierarchical B
    hierarchical_qp: bool = True
    wpp: bool = True        # entropy_coding_sync (one substream per CTU row)
    hash_type: Optional[int] = 0  # decoded_picture_hash SEI: 0 md5, 1 crc,
                                  # 2 checksum, None = no hash SEI
    rdoq: bool = False      # RDOQ-lite level optimization (opt-in: its
                            # simplified rate model trades slightly off-curve)
    sdh: bool = False       # sign data hiding (reference: slow/medium
                            # presets, Speed.h useSdh)
    search_range: int = 48
    rcudepth: Optional[bool] = None  # RCU-depth CU-range pruning
                                     # (Speed.h useRcuDepth; None = on at
                                     # medium/fast i.e. rd_candidates <= 2)
    met: Optional[bool] = None   # ME early termination (Speed.h useMet;
                                 # None = on at medium/fast)
    fdam: Optional[bool] = None  # fast decision for merge/all modes
    rqt: Optional[bool] = None   # inter one-level RQT search (Speed.h
                                 # useRqt: slow preset only); signals
                                 # max_transform_hierarchy_depth_inter=1
    esd: Optional[bool] = None   # early skip detection (Speed.h useEsd:
                                 # medium/fast): zero-residual best merge
                                 # candidate commits skip before ME
    aps: Optional[bool] = None   # adaptive partition selection (Speed.h
                                 # useAps medium+/Aps.h): residue-energy
                                 # balance gates the 2NxN/Nx2N searches
                                 # (Speed.h useFdm/useFdam; None = on at
                                 # medium/fast)
    bitrate: Optional[float] = None  # bits/s: enables CBR rate control
    ctu_rc: bool = True     # CTU-level rate control under --bitrate
                            # (CtbController analogue; False = picture-level)
    frame_rate: float = 24.0
    shot_change: bool = False  # shot-change-triggered IDR placement
    aq_strength: float = 0.0   # adaptive quantization (0 = off)
    aq_depth: int = 0   # AQ pyramid depth / QG granularity (reference
                        # --aq-depth): 0 = per-CTB dQP; d > 0 signals
                        # diff_cu_qp_delta_depth = d and the search
                        # queries per-CU offsets at layer min(cu_depth,
                        # d) (AdaptiveQuantisation.h:101,
                        # Search.hpp:1145); needs single slice/tile and
                        # no rate control
    sao: bool = True           # SAO estimation + signalling
    verify_recon: bool = True  # assert search recon == plan-replay recon
    wp_luma: Optional[tuple] = None  # explicit weighted prediction for P
                                     # slices: (weight, log2_denom, offset)
    wp_chroma: Optional[tuple] = None  # (delta_weight, delta_offset) for
                                       # both chroma planes (needs wp_luma)
    amp: bool = False          # asymmetric motion partitions (searched at
                               # rd_candidates >= 3, i.e. slow preset)
    slices: int = 1            # independent slices per picture (CTU-row
                               # aligned; requires wpp=False when > 1)
    dependent_slices: bool = False  # emit slices 2..N as dependent slice
                                    # segments of the first
    tskip: bool = False        # 4x4 transform-skip RD trials (the
                               # reference's --tskip; off in every preset,
                               # Speed.h useTSkip)
    tile_cols: int = 1         # tile grid (uniform spacing); >1 enables
    tile_rows: int = 1         # tiles (beyond the reference encoder,
                               # which only decodes tiles); needs wpp=False
    field_coding: bool = False  # code each frame as two field pictures
                                # (top-field-first), pic_struct via
                                # pic_timing SEI + VUI field_seq_flag — the
                                # reference's --field-coding
                                # (encode.cpp:379-453 field split)
    # prefix SEI set (TaskEncodeOutput.cpp:105-209 analogue)
    sei_active_parameter_sets: bool = True   # on IRAP pictures
    sei_user_data: Optional[str] = "turingcodec-tpu"  # once, at stream start
    sei_pic_timing: bool = False   # per picture; enables VUI frame-field info
    mastering_display: Optional[tuple] = None  # (primaries 3x(x,y), (wx,wy),
                                               #  max_lum, min_lum) on IRAP
    alt_transfer: Optional[int] = None  # preferred_transfer_characteristics
    sei_hrd_timing: bool = False  # buffering_period at IRAPs + pic_timing
                                  # CPB/DPB delays (needs bitrate; beyond
                                  # the reference, which emits neither)
    frame_overlap: bool = False  # inter-picture overlap: dependent
                                 # pictures encode concurrently behind a
                                 # row-granular loop-filter wavefront, MV
                                 # reach y-clamped (the reference's
                                 # --concurrent-frames operating point,
                                 # TaskEncodeSubstream.cpp:71-93 +
                                 # Search.hpp:1366-1408). Its own
                                 # deterministic operating point:
                                 # bitstreams are byte-identical at any
                                 # thread count with overlap on, but
                                 # differ from the sequential walk (the
                                 # clamp). Env TURING_TPU_FRAME_OVERLAP
                                 # overrides (1/0).
    device: Optional[str] = "cuda"  # torch device of the analysis stage
                                    # (encode/device_analysis.py): "cuda"
                                    # = on the card with the dense-ME
                                    # kernel (raises without one); None =
                                    # host path; "cpu" = the same stage
                                    # through the kernels' plain versions

    def __post_init__(self):
        if self.device is not None:
            from turingcodec_tpu_torch.encode.device_analysis import (
                resolve_device)
            resolve_device(self.device)  # raises without a usable card

    @classmethod
    def from_dict(cls, d: dict) -> "EncoderConfig":
        """Config from a field dict, e.g. dataclasses.asdict of another
        EncoderConfig; an unknown key raises."""
        return cls(**d)


class _OverlapFollower:
    """Loop-filter follower for inter-picture overlap: for every in-flight
    picture it copies finished search-recon rows into the DPB planes, runs
    the banded native deblock lagging one CTU row behind the search,
    maintains the u8 ME shadow, and publishes the final-row count that
    dependent pictures' native row-waits consume (the analogue of the
    reference's deblock/SAO tasks advancing the wavefront the next
    picture's `blocked()` checks, TaskEncodeSubstream.cpp:71-93 /
    TaskDeblock). Timing only affects WHEN rows publish, never their
    values, so bitstreams are byte-identical at any thread count."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._jobs = []
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def add(self, job):
        import threading
        job.ovl_done = threading.Event()
        job.ovl_st = {"r": 0, "e": 0, "pub": 0, "dbn": None,
                      "sao": getattr(job, "ovl_work", None) is not None}
        with self._lock:
            self._jobs.append(job)

    def stop(self):
        self._stop = True
        self._thread.join()

    def _run(self):
        import time
        while not self._stop:
            with self._lock:
                jobs = list(self._jobs)
            busy = False
            done = []
            for job in jobs:
                try:
                    if self._advance(job):
                        busy = True
                except BaseException:
                    # never leave a dependent picture waiting forever
                    job.ovl_st["error"] = True
                    job.pic.ovl_rows[0] = 1 << 30
                    job.ovl_done.set()
                if job.ovl_done.is_set():
                    done.append(job)
            if done:
                with self._lock:
                    for job in done:
                        if job in self._jobs:
                            self._jobs.remove(job)
            if not busy:
                time.sleep(0.0005)

    def _advance(self, job) -> bool:
        s = int(job.search_rows[0])
        st = job.ovl_st
        if st["r"] >= s:
            return False
        enc, pic = job.enc, job.pic
        sps = enc.sps
        H = sps.pic_height_in_luma_samples
        S = sps.ctb_size_y
        hc = sps.pic_height_in_ctbs_y
        from turingcodec_tpu_torch import native
        sao = st["sao"]
        dbl = job.ovl_work if sao else pic.planes
        if st["dbn"] is None:
            st["dbn"] = native.DeblockNative.try_create(
                enc.plan, enc.geom, *dbl)
            assert st["dbn"] is not None, "overlap requires native deblock"
        while st["r"] < s:
            r = st["r"]
            y0, y1 = r * S, min((r + 1) * S, H)
            for c, (dst, src) in enumerate(zip(dbl, enc.recon)):
                a, b = (y0, y1) if c == 0 else (y0 // 2, y1 // 2)
                dst[a:b] = src[a:b]
            # horizontal edges lag 4 luma rows (they read 4
            # vertically-filtered rows below); the last band drains them
            ey1 = H if r == hc - 1 else y1 - 4
            st["dbn"].run_band(y0, y1, st["e"], ey1)
            st["e"] = ey1
            if sao:
                # SAO rides one CTB row behind the deblock band (the
                # estimate and the EO neighbour reads need that row's
                # last lines deblocked, which band r just finalized);
                # the banded estimate equals the whole-picture raster
                # walk exactly, and the apply writes into the published
                # DPB planes from the deblocked working set
                from turingcodec_tpu_torch.encode.sao_search import estimate_sao
                rows = ([r - 1] if r >= 1 else []) \
                    + ([r] if r == hc - 1 else [])
                for cy in rows:
                    estimate_sao(enc.plan, enc.geom, job.yuv, dbl,
                                 enc.lam, cy, cy + 1)
                    sy0, sy1 = cy * S, min((cy + 1) * S, H)
                    for c, (dst, srcp) in enumerate(zip(pic.planes, dbl)):
                        a, b = (sy0, sy1) if c == 0 \
                            else (sy0 // 2, sy1 // 2)
                        dst[a:b] = srcp[a:b]
                    ok = native.sao_apply(enc.plan, enc.geom, dbl,
                                          cy, cy + 1, out=pic.planes)
                    assert ok is not None, "overlap+sao requires native"
            # rows 0..r-1 are fully final after band r (deblock: row r's
            # last 4 luma lines wait for the next band's boundary edge;
            # with SAO the same lag covers the trailing SAO row)
            pub = hc if r == hc - 1 else r
            if pub > st["pub"]:
                u8 = getattr(pic, "ovl_u8", None)
                if u8 is not None:
                    u8[st["pub"] * S:min(pub * S, H)] = \
                        pic.planes[0][st["pub"] * S:min(pub * S, H)]
                st["pub"] = pub
                pic.ovl_rows[0] = pub  # plain release store (x86 TSO);
                # pairs with the consumer's native acquire load
            st["r"] = r + 1
        if st["r"] >= hc:
            job.ovl_done.set()
        return True


class Encoder:
    def __init__(self, cfg: EncoderConfig):
        self._field = cfg.field_coding
        if self._field:
            # each field picture is half height; pic_timing carries parity
            import dataclasses
            assert cfg.height % 16 == 0, "field coding needs height % 16 == 0"
            cfg = dataclasses.replace(cfg, height=cfg.height // 2,
                                      sei_pic_timing=True)
        assert cfg.width % 8 == 0 and cfg.height % 8 == 0, \
            "conformance cropping not implemented: use multiple-of-8 sizes"
        self.cfg = cfg
        self._analysis_device = None
        if cfg.device is not None:
            from turingcodec_tpu_torch.encode.device_analysis import (
                resolve_device)
            self._analysis_device = resolve_device(cfg.device)
        self.sps = self._setup_sps()
        self.pps = self._setup_pps()
        self.vps = self._setup_vps()
        self.geom = PictureGeometry(self.sps, self.pps)
        self.frame_count = 0
        self._noise_streak = 0   # consecutive unpredictable inter pictures
        self._pool = None        # frame-parallel worker pool (lazy)
        self._ovl_state = None   # inter-picture overlap pipeline (lazy)
        self._user_data_sent = False
        self._decode_count = 0   # pictures emitted in decode order
        self._timing = {}        # input_index -> (pts, dts, keyframe)
        from turingcodec_tpu_torch.encode.gop import GopPlanner
        from turingcodec_tpu_torch.decode.dpb import Dpb
        if cfg.all_intra:
            self._planner = GopPlanner(1, intra_period=1, low_delay=True)
        else:
            self._planner = GopPlanner(cfg.gop_m, cfg.intra_period,
                                       low_delay=cfg.gop_m == 1)
        self._dpb = Dpb(self.sps)
        self._inputs = {}
        self._scd = None
        self._la_queue = []
        if cfg.shot_change:
            from turingcodec_tpu_torch.encode.scd import ShotChangeDetector
            self._scd = ShotChangeDetector(bit_depth=cfg.bit_depth)
        self._rc = None
        if cfg.bitrate:
            from turingcodec_tpu_torch.encode.rate_control import SequenceRateController
            from turingcodec_tpu_torch.encode.gop import _SOP_TABLES
            mix = {}
            m = 1 if (cfg.all_intra or cfg.gop_m == 1) else cfg.gop_m
            for (_, tid, _, _, _, _) in _SOP_TABLES[m]:
                mix[tid] = mix.get(tid, 0) + 1
            self._rc = SequenceRateController(cfg.bitrate, cfg.frame_rate,
                                              cfg.width, cfg.height, cfg.qp,
                                              level_mix=mix)
            # CPB tracker for the SIGNALLED HRD (cpb_size == the VUI's
            # cpb_size_value * 128 bits; RateControl.h:147-188 CpbInfo)
            from turingcodec_tpu_torch.encode.rate_control import CpbInfo
            cpb_bits = max(1, int(cfg.bitrate) >> 7) * 128
            self._cpb = CpbInfo(cpb_bits, cfg.bitrate,
                                cfg.frame_rate or 24.0)
            self._ctb_models = {}  # (level, ctb) -> R-lambda model

    # ------------------------------------------------------------------
    def _setup_ptl(self) -> ProfileTierLevel:
        c = self.cfg
        p = ProfileTierLevel()
        p.general_profile_idc = 1  # Main
        p.general_profile_compatibility_flags = 1 << (31 - 1)
        p.general_progressive_source_flag = 0 if self._field else 1
        p.general_interlaced_source_flag = 1 if self._field else 0
        p.general_frame_only_constraint_flag = 0 if self._field else 1
        # general_level_idc from the A.4 levels table (Encoder.cpp:590-606:
        # smallest level whose MaxLumaPs/MaxLumaSr fit the stream)
        from turingcodec_tpu_torch.hevc.tables import derive_level
        lvl, _cpb = derive_level(c.width * c.height, c.frame_rate or 24.0)
        p.general_level_idc = lvl or 120
        return p

    def _setup_sps(self) -> Sps:
        c = self.cfg
        s = Sps()
        s.ptl = self._setup_ptl()
        s.chroma_format_idc = 1
        s.pic_width_in_luma_samples = c.width
        s.pic_height_in_luma_samples = c.height
        s.bit_depth_luma_minus8 = c.bit_depth - 8
        s.bit_depth_chroma_minus8 = c.bit_depth - 8
        s.log2_max_pic_order_cnt_lsb_minus4 = 4
        s.sps_max_dec_pic_buffering_minus1 = [1]
        s.sps_max_num_reorder_pics = [0]
        s.sps_max_latency_increase_plus1 = [0]
        s.log2_min_luma_coding_block_size_minus3 = c.min_cb_log2 - 3
        s.log2_diff_max_min_luma_coding_block_size = c.ctb_log2 - c.min_cb_log2
        s.log2_min_luma_transform_block_size_minus2 = 0
        s.log2_diff_max_min_luma_transform_block_size = 3  # 4..32
        # Encoder.cpp:666 max_transform_hierarchy_depth_inter = rqt ? 1 : 0
        s.max_transform_hierarchy_depth_inter = 1 if self._rqt_on() else 0
        s.max_transform_hierarchy_depth_intra = 0
        s.scaling_list_enabled_flag = 0
        s.amp_enabled_flag = int(c.amp)
        s.sample_adaptive_offset_enabled_flag = int(c.sao)
        s.pcm_enabled_flag = 0
        s.short_term_rps = []
        s.long_term_ref_pics_present_flag = 0
        s.sps_temporal_mvp_enabled_flag = 1
        s.strong_intra_smoothing_enabled_flag = 1
        from turingcodec_tpu_torch.hevc.params import VuiParameters
        s.vui = VuiParameters()
        fr = c.frame_rate
        s.vui.timing_info = (1000, round(fr * 1000))
        s.vui.frame_field_info_present_flag = int(c.sei_pic_timing)
        s.vui.field_seq_flag = int(self._field)
        if c.bitrate:
            # CBR HRD signalling (Encoder.cpp setupHrd analogue): one CPB,
            # 1-second buffer at the target rate, fixed picture rate
            from turingcodec_tpu_torch.hevc.params import HrdParameters
            hrd = HrdParameters()
            hrd.nal_hrd_parameters_present_flag = 1
            hrd.bit_rate_scale = 2   # units of 2^(6+2) = 256 bit/s
            hrd.cpb_size_scale = 3   # units of 2^(4+3) = 128 bits
            rate = max(1, int(c.bitrate) >> 8)
            cpb = max(1, int(c.bitrate) >> 7)
            hrd.sub_layers = [{
                "fixed_pic_rate_general_flag": 1,
                "fixed_pic_rate_within_cvs_flag": 1,
                "elemental_duration_in_tc_minus1": 0,
                "low_delay_hrd_flag": 0,
                "cpb_cnt_minus1": 0,
                "nal_hrd": [{"bit_rate_value_minus1": rate - 1,
                             "cpb_size_value_minus1": cpb - 1,
                             "cbr_flag": 1}],
            }]
            s.vui.hrd = hrd
        if not self.cfg.all_intra:
            m = max(1, self.cfg.gop_m)
            s.sps_max_dec_pic_buffering_minus1 = [m + 1]
            s.sps_max_num_reorder_pics = [max(0, m - 1)]
            s.sps_max_latency_increase_plus1 = [0]
        return s

    def _rqt_on(self) -> bool:
        c = self.cfg
        if c.all_intra:
            return False
        return (c.rqt if c.rqt is not None else c.rd_candidates >= 3)

    def _setup_pps(self) -> Pps:
        c = self.cfg
        p = Pps()
        p.init_qp_minus26 = c.qp - 26
        p.sign_data_hiding_enabled_flag = int(c.sdh)
        p.entropy_coding_sync_enabled_flag = int(c.wpp)
        p.cu_qp_delta_enabled_flag = int(c.aq_strength > 0
                                         or bool(c.bitrate and c.ctu_rc))
        p.diff_cu_qp_delta_depth = (
            c.aq_depth if c.aq_strength > 0 and not c.bitrate else 0)
        p.transform_skip_enabled_flag = int(c.tskip)
        p.loop_filter_across_tiles_enabled_flag = 1
        if c.tile_cols > 1 or c.tile_rows > 1:
            # tiles encoding (beyond the reference: turing only decodes
            # tiles, encode.cpp has no tile options). Main/Main10 forbid
            # tiles together with entropy_coding_sync (A.4.1).
            if c.wpp:
                raise ValueError("tiles require wpp=False (Main profile)")
            if c.slices != 1:
                raise ValueError("tiles + multi-slice not supported")
            p.tiles_enabled_flag = 1
            p.num_tile_columns_minus1 = c.tile_cols - 1
            p.num_tile_rows_minus1 = c.tile_rows - 1
            p.uniform_spacing_flag = 1
        p.weighted_pred_flag = int(c.wp_luma is not None)
        p.dependent_slice_segments_enabled_flag = int(
            c.dependent_slices and c.slices > 1)
        return p

    def _setup_vps(self) -> Vps:
        v = Vps()
        v.ptl = self._setup_ptl()
        v.vps_max_dec_pic_buffering_minus1 = [1]
        v.vps_max_num_reorder_pics = [0]
        v.vps_max_latency_increase_plus1 = [0]
        return v

    # ------------------------------------------------------------------
    def headers(self) -> bytes:
        out = b""
        bw = BitWriter()
        write_vps(bw, self.vps)
        out += wrap_nal(T.NalUnitType.VPS_NUT, bw.get_bytes())
        bw = BitWriter()
        write_sps(bw, self.sps)
        out += wrap_nal(T.NalUnitType.SPS_NUT, bw.get_bytes())
        bw = BitWriter()
        write_pps(bw, self.pps)
        out += wrap_nal(T.NalUnitType.PPS_NUT, bw.get_bytes())
        return out

    def _slice_header(self, docket) -> SliceSegmentHeader:
        from turingcodec_tpu_torch.hevc.params import ShortTermRefPicSet

        sh = SliceSegmentHeader()
        sh.first_slice_segment_in_pic_flag = 1
        if self._rc is not None:
            qp, lam, target = self._rc.pre_picture(docket.is_idr,
                                                   docket.temporal_id,
                                                   intra_cost=getattr(
                                                       self, "_ic_cost", 0))
            # steer the allocation away from CPB over/underflow of the
            # signalled HRD (adjustAllocatedBits)
            self._rc_target = self._cpb.adjust_allocation(target)
            self._rc_qp_lam = (qp, lam)
            qp_off = qp - (26 + self.pps.init_qp_minus26)
        else:
            qp_off = docket.qp_offset if self.cfg.hierarchical_qp else 0
        sh.slice_qp_delta = qp_off
        sh.slice_qp_y = 26 + self.pps.init_qp_minus26 + qp_off
        sh.temporal_id = 0  # written in NAL header separately if desired
        sh.slice_sao_luma_flag = int(self.cfg.sao)
        sh.slice_sao_chroma_flag = int(self.cfg.sao)
        sh.slice_deblocking_filter_disabled_flag = 0
        sh.num_entry_point_offsets = 0
        if docket.is_idr:
            sh.nal_unit_type = T.NalUnitType.IDR_W_RADL
            sh.slice_type = 2
            return sh
        sh.nal_unit_type = T.NalUnitType.TRAIL_R
        sh.slice_type = docket.slice_type
        # TMVP on (Encoder.cpp:691, TaskEncodeInput.cpp:74): collocated
        # picture = first entry of L1 for B (flag 0), L0 for P (inferred 1)
        sh.slice_temporal_mvp_enabled_flag = 1
        sh.collocated_from_l0_flag = 0 if docket.slice_type == 0 else 1
        sh.collocated_ref_idx = 0
        poc = docket.poc
        sh.slice_pic_order_cnt_lsb = poc % self.sps.max_pic_order_cnt_lsb
        sh.short_term_ref_pic_set_sps_flag = 0
        # RPS: exactly the pictures this or future dockets need — anything
        # else is dropped from the DPB by the marking process
        avail = {p.poc for p in self._dpb.pics if p.is_reference}
        held = sorted((set(docket.retain) | set(docket.refs_before)
                       | set(docket.refs_after)) & avail - {poc})
        before = sorted([p for p in held if p < poc], reverse=True)
        after = sorted([p for p in held if p > poc])
        rps = ShortTermRefPicSet(
            delta_poc_s0=[p - poc for p in before],
            used_s0=[int(p in docket.refs_before) for p in before],
            delta_poc_s1=[p - poc for p in after],
            used_s1=[int(p in docket.refs_after) for p in after])
        sh.explicit_rps = rps
        sh.num_ref_idx_l0_active_minus1 = 0
        sh.num_ref_idx_l1_active_minus1 = 0
        # Speed.h setMaxNumMergeCand: 5 at slow/medium, 2 at fast — fewer
        # merge candidates to derive, SATD-rank and signal
        sh.max_num_merge_cand = 5 if self.cfg.rd_candidates >= 2 else 2
        sh.five_minus_max_num_merge_cand = 5 - sh.max_num_merge_cand
        if self.cfg.wp_luma is not None and sh.is_p:
            w, d, o = self.cfg.wp_luma
            entry = {"delta_luma_weight": w - (1 << d), "luma_offset": o}
            cflag = 0
            if self.cfg.wp_chroma is not None:
                cflag = 1
                dw, do = self.cfg.wp_chroma
                entry["chroma"] = [(dw, do), (dw, do)]
            sh.pred_weight_table = {
                "luma_log2_weight_denom": d,
                "delta_chroma_log2_weight_denom": 0,
                "l0": {"luma_flags": [1], "chroma_flags": [cflag],
                       "entries": [entry]},
            }
        return sh

    # ------------------------------------------------------------------
    def _prefix_sei(self, docket) -> bytes:
        """Prefix SEI messages for this access unit (the set the reference
        emits in TaskEncodeOutput.cpp:105-209)."""
        from turingcodec_tpu_torch.hevc import sei as S
        msgs = []
        c = self.cfg
        if docket.is_idr:
            if c.sei_active_parameter_sets:
                msgs.append(S.make_active_parameter_sets(0, 0))
            if c.sei_user_data is not None and not self._user_data_sent:
                self._user_data_sent = True
                uuid = hashlib.md5(b"turingcodec-tpu").digest()
                msgs.append(S.make_user_data_unregistered(
                    uuid, c.sei_user_data.encode()))
            if c.mastering_display is not None:
                prim, wp, mx, mn = c.mastering_display
                msgs.append(S.make_mastering_display(prim, wp, mx, mn))
            if c.alt_transfer is not None:
                msgs.append(S.make_alternative_transfer_characteristics(
                    c.alt_transfer))
        hrd_on = bool(c.sei_hrd_timing and c.bitrate)
        if hrd_on:
            # HRD timing (beyond the reference): AU counters in decode
            # order; buffering_period at every IRAP resets the CPB anchor
            au_idx = getattr(self, "_au_idx", 0)
            if docket.is_idr:
                self._cvs_start_au = au_idx
                self._last_bp_au = au_idx
                # initial CPB removal delay = signalled CPB size / bitrate
                # in 90 kHz ticks (full-buffer start)
                rate_bits = max(1, int(c.bitrate) >> 8) << 8
                cpb_bits = max(1, int(c.bitrate) >> 7) << 7
                ticks = max(1, round(90000 * cpb_bits / rate_bits))
                msgs.append(S.make_buffering_period(
                    0, nal_initial_cpb_removal_delay=[ticks],
                    nal_initial_cpb_removal_offset=[0]))
            delta = max(1, au_idx - getattr(self, "_last_bp_au", 0))
            reorder = 0 if c.all_intra else max(0, c.gop_m - 1)
            dpb_delay = reorder + docket.poc - (
                au_idx - getattr(self, "_cvs_start_au", 0))
            self._au_idx = au_idx + 1
        if c.sei_pic_timing or hrd_on:
            ps = 0
            scan = 1
            if self._field:
                # tff: even input pictures are top fields (pic_struct 1),
                # odd are bottom fields (pic_struct 2); interlaced scan
                ps = 1 if docket.input_index % 2 == 0 else 2
                scan = 0
            kw = {}
            if hrd_on:
                kw = dict(au_cpb_removal_delay_minus1=delta - 1,
                          pic_dpb_output_delay=max(0, dpb_delay))
            msgs.append(S.make_pic_timing(
                pic_struct=ps if c.sei_pic_timing else None,
                source_scan_type=scan, **kw))
        if not msgs:
            return b""
        return S.write_sei_nal(msgs, suffix=False,
                               temporal_id=docket.temporal_id)

    # ------------------------------------------------------------------
    def push_frame(self, yuv: List[np.ndarray]) -> List[tuple]:
        """Feed one input frame; returns [(input_index, nal_bytes, recon)]
        for every picture that became encodable (encode order). With field
        coding each frame becomes two field pictures (top first)."""
        if self._field:
            top = [np.ascontiguousarray(p[0::2]) for p in yuv]
            bot = [np.ascontiguousarray(p[1::2]) for p in yuv]
            return self._push_picture(top) + self._push_picture(bot)
        return self._push_picture(yuv)

    def _push_picture(self, yuv: List[np.ndarray]) -> List[tuple]:
        idx = self.frame_count
        self.frame_count += 1
        self._inputs[idx] = yuv
        out = []
        if self._scd is not None:
            # lookahead: SCD decisions for frame c finalize at frame c+5
            # (InputQueue::preanalyse window, InputQueue.cpp:413-427) —
            # inputs wait in the lookahead queue until decided so the IDR
            # lands exactly on the cut
            self._scd.push(yuv[0])
            self._la_queue.append(idx)
            dockets = []
            while self._la_queue and self._la_queue[0] < \
                    self._scd.decided_upto():
                i = self._la_queue.pop(0)
                dockets += self._planner.push(self._scd.is_shot_change(i))
            return out + self._encode_dockets(dockets)
        return out + self._encode_dockets(self._planner.push(False))

    def flush(self) -> List[tuple]:
        dockets = []
        if self._scd is not None:
            self._scd.finish()
            while self._la_queue:
                i = self._la_queue.pop(0)
                dockets += self._planner.push(self._scd.is_shot_change(i))
        dockets += self._planner.flush()
        return self._encode_dockets(dockets) + self._drain_overlap()

    # ------------------------------------------------------------------
    def _frame_threads(self) -> int:
        """In-flight picture budget (reference --concurrent-frames
        analogue). Frame-parallel encoding is bit-identical with the
        sequential walk (asserted by a signature row): batches contain
        only mutually-independent pictures, and all cross-picture state
        (DPB/RPS, SEI counters, noise streak) advances in the sequential
        prepare/finalize phases. Rate control stays sequential (its
        picture model chains through every picture's actual bits)."""
        if self._rc is not None or self.cfg.slices > 1:
            return 1
        import os

        from turingcodec_tpu_torch import native
        if native.get_lib() is None \
                or os.environ.get("TURING_TPU_NO_NATIVE_ENC") \
                or os.environ.get("TURING_TPU_NO_NATIVE"):
            # the pure-Python search shares module-level caches across
            # pictures; only the native path (per-thread contexts) is
            # designed and signature-pinned for concurrent pictures
            return 1
        v = os.environ.get("TURING_TPU_FRAME_THREADS")
        if v:
            return max(1, int(v))
        return 2 if (os.cpu_count() or 1) > 1 else 1

    # ------------------------------------------------------------------
    def _overlap_on(self) -> bool:
        """Inter-picture overlap (the reference's --concurrent-frames
        dependent-picture wavefront): opt-in, its own deterministic
        operating point (see EncoderConfig.frame_overlap)."""
        import os
        v = os.environ.get("TURING_TPU_FRAME_OVERLAP")
        on = self.cfg.frame_overlap if v is None else v not in ("", "0")
        if not on:
            return False
        cfg = self.cfg
        # picture-level rate control works under overlap via the fixed-lag
        # rendezvous (see _encode_dockets_overlap); CTU-level RC shares
        # per-CTB model state across in-flight pictures and stays
        # sequential (the reference's RC token scheme has the same
        # picture-level structure, RateControl.cpp:849 hierarchyLevel -
        # concurrentFrames)
        if ((self._rc is not None and cfg.ctu_rc) or cfg.slices > 1
                or cfg.aq_strength > 0 or cfg.tile_cols > 1
                or cfg.tile_rows > 1 or cfg.wp_luma is not None
                or cfg.tskip):
            return False
        if os.environ.get("TURING_TPU_NO_NATIVE") \
                or os.environ.get("TURING_TPU_NO_NATIVE_ENC") \
                or os.environ.get("TURING_TPU_NO_NATIVE_RECON"):
            return False
        from turingcodec_tpu_torch import native
        return native.get_lib() is not None

    def _ovl_frames(self) -> int:
        """In-flight picture budget for overlap mode: fixed 4 like the
        reference (encode.cpp:151) so bitstreams never depend on the
        host's core count — under rate control the in-flight depth IS
        the RC feedback lag (like the reference's --concurrent-frames),
        so the env override changes RC bitstreams, exactly as theirs
        does."""
        import os
        v = os.environ.get("TURING_TPU_FRAME_THREADS")
        if v:
            return max(1, int(v))
        return 4

    def _encode_dockets_overlap(self, dockets) -> List[tuple]:
        """Pipelined dependent-picture encoding: prepare sequentially,
        encode each picture on its own worker behind the native
        row-granular wavefront, finalize strictly in decode order.
        Results return as pictures complete (push_frame may return [] and
        a later call several — same contract as GOP reordering)."""
        from concurrent.futures import ThreadPoolExecutor
        from turingcodec_tpu_torch import native
        st = self._ovl_state
        if st is None:
            st = self._ovl_state = {
                "q": [], "pool": ThreadPoolExecutor(
                    max_workers=self._ovl_frames()),
                "fol": _OverlapFollower()}
        ft = self._ovl_frames()
        wpp = max(1, native.enc_threads() // min(ft, 2))
        out = []

        def run(job):
            native.bind_thread_ctx()
            native.set_thread_enc_threads(wpp)
            self._docket_encode(job)

        for d in dockets:
            while len(st["q"]) >= ft:
                j0, f0 = st["q"].pop(0)
                f0.result()
                out.append(self._docket_finalize(j0))
            job = self._docket_prepare(d)
            st["fol"].add(job)
            st["q"].append((job, st["pool"].submit(run, job)))
        # opportunistic early finalize of completed pictures — but NOT
        # under rate control: there the finalize schedule must be a pure
        # function of the docket sequence (prepare(i) sees exactly the
        # pictures <= i-ft finalized — the fixed RC feedback lag), never
        # of completion timing
        if self._rc is None:
            while st["q"] and st["q"][0][1].done():
                j0, f0 = st["q"].pop(0)
                f0.result()
                out.append(self._docket_finalize(j0))
        return out

    def _drain_overlap(self) -> List[tuple]:
        st = self._ovl_state
        out = []
        if st is not None:
            while st["q"]:
                j0, f0 = st["q"].pop(0)
                f0.result()
                out.append(self._docket_finalize(j0))
        return out

    def _encode_dockets(self, dockets) -> List[tuple]:
        if self._overlap_on():
            return self._encode_dockets_overlap(dockets)
        ft = self._frame_threads()
        out = []
        i = 0
        while i < len(dockets):
            batch = [dockets[i]]
            i += 1
            while ft > 1 and i < len(dockets) and len(batch) < ft:
                d = dockets[i]
                pocs = {b.poc for b in batch}
                if d.is_idr or any(b.is_idr for b in batch) \
                        or pocs & set(d.refs_before) \
                        or pocs & set(d.refs_after):
                    break
                batch.append(d)
                i += 1
            jobs = [self._docket_prepare(d) for d in batch]
            if len(jobs) == 1:
                self._docket_encode(jobs[0])
            else:
                from turingcodec_tpu_torch import native
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._pool = ThreadPoolExecutor(max_workers=ft)
                wpp = max(1, native.enc_threads() // len(jobs))

                def run(job):
                    native.bind_thread_ctx()
                    native.set_thread_enc_threads(wpp)
                    self._docket_encode(job)

                list(self._pool.map(run, jobs))
            out += [self._docket_finalize(j) for j in jobs]
        return out

    def timing(self, input_index: int):
        """(pts, dts, keyframe) for an emitted picture, 90 kHz clock —
        the turing_encoder_output fields (turing.h:61-67)."""
        return self._timing[input_index]

    # back-compat single-frame API (valid for all-intra / low-delay m=1)
    def encode_frame(self, yuv: List[np.ndarray]) -> tuple:
        res = self.push_frame(yuv)
        assert len(res) == 1, "encode_frame requires gop_m=1"
        _, nal, recon = res[0]
        return nal, recon

    # ------------------------------------------------------------------
    def _apply_aq_qp(self, plan, qp_layers):
        """Per-CU AQ: decoder-visible QpY per 4x4 block from the committed
        quadtree — each CU carries layer min(ct_depth, D)'s QP at its
        position, a pure function of position+depth, which is exactly
        what both search twins quantized with."""
        D = len(qp_layers) - 1
        ct = np.minimum(plan.ct_depth.astype(np.int32), D)
        h4, w4 = ct.shape
        ctb_l2 = self.sps.ctb_log2_size_y
        out = plan.qp_y
        for d, qm in enumerate(qp_layers):
            rep = 1 << (ctb_l2 - d - 2)
            up = np.repeat(np.repeat(qm, rep, 0), rep, 1)[:h4, :w4]
            np.copyto(out, up.astype(out.dtype), where=(ct == d))

    def _reconcile_qp_qg(self, plan, sh):
        """Decoder-derivable QpY rewrite for cu_qp_delta streams (any
        diff_cu_qp_delta_depth, incl. 0): mirrors the decoders' per-CU
        derivation — each CU's QpY = qPY_PRED + the CuQpDeltaVal state
        as of ITS parse, so CUs of a quantization group parsed BEFORE
        the group's first coded coefficient keep qPY_PRED + 0 (the
        reference QpState semantics, cross-verified bit-exact against
        the reference decoder on its own --aq streams). qPY_PRED =
        (qPY_A + qPY_B + 1) >> 1 from the left/above QGs inside the same
        CTB, else qPY_PREV; qPY_PREV resets per slice and (WPP) per CTB
        row. Groups have max(QG, CU) extent and walk in z-order."""
        sps = self.sps
        ctb_l2 = sps.ctb_log2_size_y
        ctb = 1 << ctb_l2
        qg_l2 = ctb_l2 - self.pps.diff_cu_qp_delta_depth
        W = sps.pic_width_in_luma_samples
        H = sps.pic_height_in_luma_samples
        wc, hc = sps.pic_width_in_ctbs_y, sps.pic_height_in_ctbs_y
        wpp = bool(self.pps.entropy_coding_sync_enabled_flag)
        qp = plan.qp_y
        mincb_l2 = sps.min_cb_log2_size_y

        def zorder(n):
            out = []
            for zi in range(n * n):
                zx = zy = 0
                for b in range(8):
                    zx |= ((zi >> (2 * b)) & 1) << b
                    zy |= ((zi >> (2 * b + 1)) & 1) << b
                out.append((zy, zx))
            return out

        z_qg = zorder(ctb >> qg_l2)

        def cu_nz(x0, y0, g):
            y1, x1 = min(y0 + g, H), min(x0 + g, W)
            return bool(
                plan.coeff_y[y0:y1, x0:x1].any()
                or plan.coeff_cb[y0 >> 1:y1 >> 1, x0 >> 1:x1 >> 1].any()
                or plan.coeff_cr[y0 >> 1:y1 >> 1, x0 >> 1:x1 >> 1].any())

        last = sh.slice_qp_y
        for ry in range(hc):
            if wpp:
                last = sh.slice_qp_y
            for rx in range(wc):
                for (zy, zx) in z_qg:
                    x0 = rx * ctb + (zx << qg_l2)
                    y0 = ry * ctb + (zy << qg_l2)
                    if x0 >= W or y0 >= H:
                        continue
                    g_l2 = max(int(plan.cu_size_log2[y0 >> 2, x0 >> 2]),
                               qg_l2)
                    g = 1 << g_l2
                    if (x0 & (g - 1)) or (y0 & (g - 1)):
                        continue  # not this group's origin cell
                    a = b_ = last
                    if x0 > 0 and ((x0 - 1) >> ctb_l2) == (x0 >> ctb_l2):
                        a = int(qp[y0 >> 2, (x0 - 1) >> 2])
                    if y0 > 0 and ((y0 - 1) >> ctb_l2) == (y0 >> ctb_l2):
                        b_ = int(qp[(y0 - 1) >> 2, x0 >> 2])
                    pred = (a + b_ + 1) >> 1
                    # walk the group's CUs in z-order: before the first
                    # CU with a coded coefficient, QpY = pred
                    coded = False
                    cu_qp = pred
                    for (cy, cx) in zorder(g >> mincb_l2):
                        cx0 = x0 + (cx << mincb_l2)
                        cy0 = y0 + (cy << mincb_l2)
                        if cx0 >= W or cy0 >= H:
                            continue
                        cl2 = int(plan.cu_size_log2[cy0 >> 2, cx0 >> 2])
                        cs = 1 << cl2
                        if (cx0 & (cs - 1)) or (cy0 & (cs - 1)):
                            continue  # interior cell of a CU
                        if not coded and cu_nz(cx0, cy0, cs):
                            coded = True
                            cu_qp = int(qp[cy0 >> 2, cx0 >> 2])
                        cv = cu_qp if coded else pred
                        y1, x1 = min(cy0 + cs, H), min(cx0 + cs, W)
                        qp[cy0 >> 2:(y1 + 3) >> 2,
                           cx0 >> 2:(x1 + 3) >> 2] = cv
                        last = cv

    # ------------------------------------------------------------------
    def _encode_docket(self, docket) -> tuple:
        """Sequential single-picture path: prepare + encode + finalize."""
        job = self._docket_prepare(docket)
        self._docket_encode(job)
        return self._docket_finalize(job)

    def _docket_prepare(self, docket):
        """Sequential phase: everything that touches cross-picture state —
        DPB/RPS, SEI counters, lambda/RC setup, pre-analysis (noise
        streak), and the DPB stub insertion so the NEXT picture's RPS sees
        this one. Returns the job consumed by _docket_encode."""
        from types import SimpleNamespace
        from turingcodec_tpu_torch.decode.dpb import DecodedPicture
        from turingcodec_tpu_torch.encode.inter_search import InterPictureEncoder

        # PTS/DTS assignment (InputQueue::append, InputQueue.cpp:386-405):
        # dts of the n-th picture in decode order is the pts of input
        # n - reorderDelay (3), extrapolated backwards before the start;
        # 90 kHz clock synthesized from the configured frame rate
        period = 90000.0 / (self.cfg.frame_rate or 24.0)
        self._timing[docket.input_index] = (
            int(round(docket.input_index * period)),
            int(round((self._decode_count - 3) * period)),
            int(docket.is_idr))
        self._decode_count += 1

        yuv = self._inputs.pop(docket.input_index)
        # intra complexity pre-analysis for the rate control's intra
        # allocation (EstimateIntraComplexity; TaskEncodeInput.cpp:284-312)
        self._ic_cost = 0
        if self._rc is not None and docket.is_idr:
            from turingcodec_tpu_torch.encode.rate_control import intra_complexity
            self._ic_cost = intra_complexity(np.asarray(yuv[0]),
                                             self.cfg.bit_depth)
        sh = self._slice_header(docket)
        poc = 0 if docket.is_idr else docket.poc
        self._dpb.poc = poc
        self._dpb.apply_rps(sh, poc)
        self._dpb.build_ref_lists(sh)

        import os
        ovl = self._overlap_on()
        if os.environ.get("TC_SRC_SEEDS") or ovl:
            # stash source Y planes for source-referenced pre-analysis
            # (pocs reset at IDR: clear so stale planes can't collide).
            # Overlap mode REQUIRES source-referenced analysis: reference
            # reconstructions are still being encoded at prepare time.
            if docket.is_idr:
                self._src_by_poc = {}
            stash = self.__dict__.setdefault("_src_by_poc", {})
            stash[poc] = np.asarray(yuv[0])
            for p in sorted(stash)[:-12]:
                del stash[p]

        if sh.is_i:
            enc = IntraPictureEncoder(self.sps, self.pps, sh, self.geom,
                                      rd_candidates=self.cfg.rd_candidates,
                                      max_cu_log2=self.cfg.max_cu_log2,
                                      use_rdoq=self.cfg.rdoq)
        else:
            enc = InterPictureEncoder(
                self.sps, self.pps, sh, self.geom,
                self._dpb.ref_pic_list, poc,
                rd_candidates=self.cfg.rd_candidates,
                max_cu_log2=self.cfg.max_cu_log2,
                search_range=self.cfg.search_range,
                use_rdoq=self.cfg.rdoq)
            # RCU-depth (Speed.h useRcuDepth: medium/fast default)
            enc.rcudepth = (self.cfg.rcudepth
                            if self.cfg.rcudepth is not None
                            else self.cfg.rd_candidates <= 2)
            enc.met = (self.cfg.met if self.cfg.met is not None
                       else self.cfg.rd_candidates <= 2)
            enc.fdam = (self.cfg.fdam if self.cfg.fdam is not None
                        else self.cfg.rd_candidates <= 2)
            # inter RQT search (Speed.h useRqt: slow only)
            enc.rqt = self._rqt_on()
            # early skip detection (Speed.h useEsd: medium/fast)
            enc.esd = (self.cfg.esd if self.cfg.esd is not None
                       else self.cfg.rd_candidates <= 2)
            # adaptive partition selection (Speed.h useAps: medium+)
            enc.aps = (self.cfg.aps if self.cfg.aps is not None
                       else self.cfg.rd_candidates == 2)
            # noise-adaptive RDOQ persistence: only a STREAK of
            # unpredictable inter pictures means noise (a lone one is a
            # scene cut, whose coded detail future frames need)
            enc.noise_streak = self._noise_streak
            enc.device = self._analysis_device
        # picture lambda (Measure.h computeLambda parity): per-position
        # qpFactor with the I-slice gopM scale and the non-anchor multiplier
        import math
        m = 1 if (self.cfg.all_intra or self.cfg.gop_m == 1) \
            else self.cfg.gop_m
        qp_pic = sh.slice_qp_y
        if sh.is_i:
            scale = 1.0 - min(max(0.05 * (m - 1.0), 0.0), 0.5)
            if scale < 1.0 and self._idr_unpredictable(docket, yuv):
                # the gopM discount buys I-frame quality that propagates
                # through prediction; on temporally-unpredictable (noise)
                # content nothing propagates, and the discounted lambda
                # overspends on a flat RD surface (measured: 3.3x I-frame
                # rate for +0.35 dB at the synthetic qp38 tail) — keep
                # the undiscounted intra lambda there
                scale = 1.0
            qf = 0.57 * scale
        else:
            qf = docket.qp_factor
        lam = qf * (2.0 ** ((qp_pic - 12.0) / 3.0))
        if not sh.is_i and docket.poc % m:
            lam *= min(max((qp_pic - 12.0) / 6.0, 2.0), 4.0)
        enc.lam = lam
        enc.lam_bits = lam
        if hasattr(enc, "lam_me"):
            enc.lam_me = math.sqrt(lam)
        self._pic_lambda = lam
        if self._rc is not None and self.cfg.ctu_rc:
            # CTU-level rate control (CtbController; Write.h:745-765):
            # the search asks for each CTB's QP right before encoding it
            # and reports its exact committed bits right after
            from turingcodec_tpu_torch.encode.rate_control import (
                CtbRateController, intra_complexity_map)
            icm = None
            if sh.is_i:
                icm = intra_complexity_map(np.asarray(yuv[0]),
                                           self.sps.ctb_log2_size_y,
                                           self.cfg.bit_depth)
            enc.ctu_rc = CtbRateController(
                self.geom.wc, self.geom.hc, self.sps.ctb_size_y,
                self.cfg.width, self.cfg.height, self._rc_target,
                sh.slice_qp_y, lam, sh.is_i, self._ctb_models,
                "I" if sh.is_i else docket.temporal_id, intra_costs=icm)
        elif self.cfg.aq_strength > 0:
            from turingcodec_tpu_torch.encode.aq import compute_aq_layers
            D = self.cfg.aq_depth
            if D > 0:
                assert (self.cfg.slices == 1 and self.cfg.tile_cols == 1
                        and self.cfg.tile_rows == 1),                     "per-CU AQ needs a single slice/tile"
            layers = compute_aq_layers(np.asarray(yuv[0]),
                                       self.sps.ctb_log2_size_y,
                                       self.cfg.aq_strength, D)
            qp_layers = [np.clip(sh.slice_qp_y + d_, 1, 51)
                         for d_ in layers]
            enc.set_qp_map(qp_layers[0])
            if D > 0:
                # full-QP maps per layer (luma + derived chroma, bd
                # offsets in) for the per-CU query in both search twins
                from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
                sps, pps = self.sps, self.pps
                lo = -sps.qp_bd_offset_c

                def cfull(qm, off):
                    f = np.vectorize(lambda q: chroma_qp_from_luma(
                        int(max(lo, min(57, q + off)))))
                    return (f(qm) + sps.qp_bd_offset_c).astype(np.int32)

                enc._aq_layers_full = [
                    ((qm + sps.qp_bd_offset_y).astype(np.int32),
                     cfull(qm, pps.pps_cb_qp_offset),
                     cfull(qm, pps.pps_cr_qp_offset))
                    for qm in qp_layers]
                enc._aq_qp_layers = qp_layers
        n_slices = max(1, self.cfg.slices)
        if n_slices > 1:
            assert not self.cfg.wpp and self.cfg.aq_strength == 0, \
                "multi-slice encoding requires wpp=False and no AQ"
            hc = self.geom.hc
            n_slices = min(n_slices, hc)
            bounds = [round(i * hc / n_slices) for i in range(n_slices + 1)]
            rows = np.zeros(hc, np.int32)
            dep = self.cfg.dependent_slices
            for i in range(n_slices):
                # dependent segments share slice number 0: in-picture
                # prediction continues across segment boundaries
                rows[bounds[i]:bounds[i + 1]] = 0 if dep else i
            enc.slice_row_map = rows

        # device rank-SATD tables (source-referenced ranking presets):
        # pure function of the input picture, computed for I and inter
        # pictures alike; the native search reads the installed integers
        # instead of sweeping (byte-identical — exact twins)
        dev = self._analysis_device
        if dev is not None:
            from turingcodec_tpu_torch.encode.device_analysis import (
                device_enc_enabled, rank_satd_tables_device)
            if (device_enc_enabled(dev)
                    and not os.environ.get("TC_NO_SRC_RANK")
                    and (self.cfg.rd_candidates <= 2
                         or os.environ.get("TC_SRC_RANK"))
                    and self.cfg.slices == 1 and self.cfg.tile_cols == 1
                    and self.cfg.tile_rows == 1):
                enc._device_ranksatd = rank_satd_tables_device(
                    np.asarray(yuv[0]), self.geom.zscan, self.cfg.bit_depth,
                    bool(self.sps.strong_intra_smoothing_enabled_flag), dev)

        # pre-analysis (device fields + noise streak) is cross-picture
        # sequential state: run it here, not in the parallel encode phase
        enc._overlap = ovl
        if not sh.is_i:
            # TC_SRC_SEEDS: analyse against reference SOURCES (stashed Y
            # planes) instead of reconstructions — removes the analysis'
            # recon dependency (GOP-batchable; overlap-safe). Overlap
            # mode depends on it: in-flight reference reconstructions
            # must not be read here.
            if os.environ.get("TC_SRC_SEEDS") or ovl:
                stash = getattr(self, "_src_by_poc", {})
                ss = {}
                for lx, refs in enumerate(self._dpb.ref_pic_list):
                    if refs and refs[0].poc in stash:
                        ss[lx] = stash[refs[0].poc]
                if ss:
                    enc._seed_src = ss
            enc.prepare_analysis(yuv)
            self._noise_streak = getattr(enc, "noise_streak",
                                         self._noise_streak)

        # DPB stub: inserted now so the NEXT picture's RPS retains this
        # one; planes/plan are filled in _docket_finalize (nothing reads
        # them before this batch completes — batches are independent).
        # Overlap mode pre-allocates the final planes + live plan here so
        # dependent pictures bind them before this one finishes: samples
        # are valid up to the follower-published row count, plan tensors
        # (TMVP motion) up to the search's published rows.
        pic = DecodedPicture(poc=poc)
        pic.is_reference = True
        self._dpb.picture_done(pic, sh)

        job = SimpleNamespace(
            docket=docket, yuv=yuv, sh=sh, poc=poc, enc=enc,
            n_slices=n_slices, bounds=bounds if n_slices > 1 else None,
            nal_prefix=self._prefix_sei(docket), pic=pic,
            nal=None, recon=None, plan=None, ovl=ovl)
        if ovl:
            from turingcodec_tpu_torch.decode.plan import PicturePlan
            sps = self.sps
            h, w = (sps.pic_height_in_luma_samples,
                    sps.pic_width_in_luma_samples)
            plan = PicturePlan(sps, self.pps)
            enc._preset_plan = plan
            pic.plan = plan
            pic.planes = [np.zeros((h, w), np.int16),
                          np.zeros((h // 2, w // 2), np.int16),
                          np.zeros((h // 2, w // 2), np.int16)]
            pic.ovl_rows = np.zeros(1, np.int64)
            if self.cfg.bit_depth == 8:
                pic.ovl_u8 = np.zeros((h, w), np.uint8)
            if self.cfg.sao:
                # SAO reads the DEBLOCKED picture: the follower keeps it
                # in this working set and publishes the SAO output into
                # pic.planes
                job.ovl_work = [np.zeros((h, w), np.int16),
                                np.zeros((h // 2, w // 2), np.int16),
                                np.zeros((h // 2, w // 2), np.int16)]
            job.search_rows = np.zeros(1, np.int64)
            enc._ovl_self_rows = job.search_rows
        return job

    def _idr_unpredictable(self, docket, yuv) -> bool:
        """Lookahead temporal-unpredictability of an IDR: dense-ME the IDR
        source against the NEXT input picture (the RA planner holds the
        IDR one input so it is available) and compare the winner-SAD
        median against the noise threshold — the same integer field and
        rule the inter noise-adaptive RDOQ uses, so the decision is a
        deterministic function of the inputs."""
        import os
        if os.environ.get("TC_NO_NOISE_ADAPT") \
                or os.environ.get("TC_NO_DENSEME") \
                or os.environ.get("TC_NO_LOWRES") \
                or self._rc is not None:
            return False
        nxt = self._inputs.get(docket.input_index + 1)
        if nxt is None:
            return False
        from turingcodec_tpu_torch import native
        from turingcodec_tpu_torch.encode.inter_search import InterPictureEncoder
        a = np.asarray(yuv[0])
        res = native.dense_analysis(np.asarray(nxt[0]), a,
                                    self.cfg.bit_depth)
        if res is not None:
            dsad = res[2]
        else:
            probe = InterPictureEncoder.__new__(InterPictureEncoder)
            probe._lr_seed_cache = {}
            probe._dense_cache = {}
            probe.orig = [np.asarray(nxt[0])]
            dsad = probe._dense_field(a)[1]
        flat = np.sort(np.asarray(dsad), axis=None)
        return int(flat[flat.size // 2]) \
            > InterPictureEncoder.NOISE_SAD_MEDIAN

    def _docket_encode(self, job) -> None:
        """Parallel-safe phase: the picture's RDO, loop filters, SAO
        estimation and CABAC write — no cross-picture state (worker
        threads bind their own native context, native.bind_thread_ctx)."""
        docket, yuv, sh, enc = job.docket, job.yuv, job.sh, job.enc
        n_slices, bounds = job.n_slices, job.bounds
        plan, search_recon = enc.encode_picture(yuv)
        if getattr(enc, "_aq_qp_layers", None):
            self._apply_aq_qp(plan, enc._aq_qp_layers)
            self._reconcile_qp_qg(plan, sh)
        elif self.cfg.aq_strength > 0 or getattr(enc, "ctu_rc", None):
            self._reconcile_qp_qg(plan, sh)

        if job.ovl:
            # overlap: the follower deblocked band-by-band behind the
            # search into the pre-allocated DPB planes; wait for it to
            # drain the tail bands (sample-exact with the whole-picture
            # pass — banded-deblock equivalence is pinned by test)
            job.ovl_done.wait()
            if job.ovl_st.get("error"):
                raise RuntimeError("overlap follower failed")
            recon = job.pic.planes
        else:
            # reconstruction: search recon + the decoder's own deblocking
            # over the same plan (round-trip tests assert bit-exact
            # decoder agreement, the signature.cpp:171-177 invariant)
            from turingcodec_tpu_torch.decode.deblock_vec import (
                deblock_picture_vec)
            recon = [p.copy() for p in search_recon]
            deblock_picture_vec(plan, self.geom, recon[0], recon[1],
                                recon[2])

        if self.cfg.sao and not job.ovl:
            # SAO estimation needs the deblocked picture; its parameters
            # go into the per-CTU syntax, so estimate before writing
            # slice data (under overlap the follower estimated + applied
            # per band already — identical raster decisions)
            from turingcodec_tpu_torch.encode.sao_search import estimate_sao
            estimate_sao(plan, self.geom, yuv, recon, enc.lam)

        # slice data: WPP entry point offsets go into the header.
        # Offsets count EBSP bytes; per-substream emulation prevention equals
        # whole-buffer EP3 because every substream ends in a non-zero byte
        # (the CABAC flush '1' lands in the final byte).
        from turingcodec_tpu_torch.bitstream.reader import insert_emulation_prevention
        nal = job.nal_prefix
        if n_slices == 1:
            seg_shs = [sh]
        else:
            import copy
            dep = self.cfg.dependent_slices
            seg_shs = []
            for si in range(n_slices):
                shi = sh if si == 0 else copy.copy(sh)
                if si > 0:
                    shi.first_slice_segment_in_pic_flag = 0
                    shi.slice_segment_address = bounds[si] * self.geom.wc
                    shi.dependent_slice_segment_flag = int(dep)
                seg_shs.append(shi)
            plan.slice_headers = [s for s in seg_shs
                                  if not s.dependent_slice_segment_flag]
        seg_state = None
        for si, shi in enumerate(seg_shs):
            dep_seg = bool(shi.dependent_slice_segment_flag)
            end_ts = None
            if n_slices > 1 and self.cfg.dependent_slices:
                end_ts = bounds[si + 1] * self.geom.wc
            substreams, seg_state = write_slice_data(
                plan, self.geom, shi, 0 if dep_seg or n_slices == 1 else si,
                init_state=seg_state if dep_seg else None, end_ts=end_ts)
            if len(substreams) > 1:
                ep = [len(insert_emulation_prevention(s))
                      for s in substreams[:-1]]
                shi.num_entry_point_offsets = len(ep)
                shi.offset_len_minus1 = max(
                    1, max(e - 1 for e in ep).bit_length()) - 1
                shi.entry_point_offset_minus1 = [e - 1 for e in ep]
            else:
                shi.num_entry_point_offsets = 0
            bw = BitWriter()
            write_slice_segment_header(bw, shi, self.sps, self.pps)
            rbsp = bw.get_bytes() + b"".join(substreams)
            nal += wrap_nal(shi.nal_unit_type, rbsp,
                            temporal_id=docket.temporal_id)

        if self.cfg.sao and not job.ovl:
            from turingcodec_tpu_torch.decode.sao import sao_picture
            recon = sao_picture(plan, self.geom, recon)
        if self.cfg.hash_type is not None:
            from turingcodec_tpu_torch.hevc.sei import (
                make_decoded_picture_hash, write_sei_nal)
            msg = make_decoded_picture_hash(recon, self.cfg.hash_type,
                                            self.cfg.bit_depth)
            nal += write_sei_nal([msg], suffix=True,
                                 temporal_id=docket.temporal_id)
        job.nal = nal
        job.recon = recon
        job.plan = plan

    def _docket_finalize(self, job) -> tuple:
        """Sequential phase, in docket order: rate-control/CPB updates and
        filling the DPB stub with the finished planes/plan."""
        nal, sh, enc = job.nal, job.sh, job.enc
        if self._rc is not None:
            self._rc.post_picture(8 * len(nal))
            self._cpb.update(8 * len(nal))
        job.pic.planes = job.recon
        job.pic.plan = job.plan
        self._last_plan = job.plan
        # exposed for the checkRate invariant test (encode/rate_check.py)
        self._last_sh = sh
        self._last_ctu_frac = list(enc.ctu_frac_list)
        return job.docket.input_index, nal, job.recon


def read_yuv_frame(yuv_bytes: bytes, i: int, w: int, h: int):
    fsz = w * h * 3 // 2
    off = i * fsz
    y = np.frombuffer(yuv_bytes[off:off + w * h],
                      np.uint8).reshape(h, w).astype(np.int16)
    cb = np.frombuffer(yuv_bytes[off + w * h:off + w * h + w * h // 4],
                       np.uint8).reshape(h // 2, w // 2).astype(np.int16)
    cr = np.frombuffer(yuv_bytes[off + w * h + w * h // 4:off + fsz],
                       np.uint8).reshape(h // 2, w // 2).astype(np.int16)
    return [y, cb, cr]


def encode_yuv_stream(yuv_bytes: bytes, cfg: EncoderConfig,
                      n_frames: Optional[int] = None) -> tuple:
    """Encode raw 4:2:0 YUV; returns (bitstream bytes, recon md5 hex).

    Recon md5 is over *input-order* reconstructions.
    """
    w, h = cfg.width, cfg.height
    fsz = w * h * 3 // 2
    total = len(yuv_bytes) // fsz
    if n_frames is not None:
        total = min(total, n_frames)
    enc = Encoder(cfg)
    out = [enc.headers()]
    recons = {}
    for i in range(total):
        for (idx, nal, recon) in enc.push_frame(read_yuv_frame(yuv_bytes, i, w, h)):
            out.append(nal)
            recons[idx] = recon
    for (idx, nal, recon) in enc.flush():
        out.append(nal)
        recons[idx] = recon
    md5 = hashlib.md5()
    for i in range(total):
        for p in recons[i]:
            md5.update(p.astype(np.uint8).tobytes())
    return b"".join(out), md5.hexdigest()
