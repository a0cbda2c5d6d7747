"""Top-level HEVC decoder: NAL loop -> headers -> per-picture parse +
reconstruction -> DPB output.

Parity reference: turing/decode.cpp:101-126 (the whole decode as one walk),
turing/StateDecode.h (output + md5), turing/Read.hpp:69-131 (NAL dispatch).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from turingcodec_tpu_torch.bitstream.reader import BitReader, iter_nal_units
from turingcodec_tpu_torch.cabac.engine import ContextPool
from turingcodec_tpu_torch.hevc import types as T
from turingcodec_tpu_torch.hevc.geometry import PictureGeometry
from turingcodec_tpu_torch.hevc.header_syntax import (
    parse_pps,
    parse_slice_segment_header,
    parse_sps,
    parse_vps,
)
from turingcodec_tpu_torch.hevc.params import ParamSets
from turingcodec_tpu_torch.decode.dpb import DecodedPicture, Dpb
from turingcodec_tpu_torch.decode.violations import Violation
from turingcodec_tpu_torch.decode.mvp import InterDeriver
from turingcodec_tpu_torch.decode.picture_recon import PictureReconstructor
from turingcodec_tpu_torch.decode.plan import PicturePlan
from turingcodec_tpu_torch.decode.slice_data import parse_slice_segment_data
from turingcodec_tpu_torch.utils.profiler import TRACE


@dataclass
class DecodedFrame:
    poc: int
    planes: list  # [y, cb, cr] int16
    hash_ok: Optional[bool] = None  # decoded_picture_hash SEI verification


_SEGMENT_FIELDS = {
    # per-segment syntax NOT inherited by dependent slice segments (7.4.7.1)
    "first_slice_segment_in_pic_flag", "dependent_slice_segment_flag",
    "slice_segment_address", "num_entry_point_offsets", "offset_len_minus1",
    "entry_point_offset_minus1", "nal_unit_type", "temporal_id",
    "no_output_of_prior_pics_flag", "slice_pic_parameter_set_id",
}


def _inherit_slice_header(dep, prev):
    """Copy inherited slice-header values into a dependent segment header
    (spec 7.4.7.1: dependent segments share the independent header)."""
    import dataclasses
    for f in dataclasses.fields(type(dep)):
        if f.name not in _SEGMENT_FIELDS:
            setattr(dep, f.name, getattr(prev, f.name))


class Decoder:
    """Streaming HEVC decoder. Feed an Annex-B byte stream; yields frames in
    output order."""

    def __init__(self, reconstructor_cls=PictureReconstructor,
                 device="cuda"):
        """device: a torch device ("cuda", the default, or "cpu") runs the
        chained device pipeline there; None decodes on the host. "cuda"
        without a usable card raises: the decoder never falls back to the
        host."""
        self.device = None
        if device is not None:
            from turingcodec_tpu_torch.encode.device_analysis import (
                resolve_device)
            self.device = resolve_device(device)
        self.ps = ParamSets()
        self.dpb: Optional[Dpb] = None
        self.geom: Optional[PictureGeometry] = None
        self._geom_key = None
        self.first_picture = True
        self.skip_rasl = False
        self.reconstructor_cls = reconstructor_cls
        self.frame_count = 0
        self._pending_sei = []
        self.sei_log = []  # (payload_type, structured dict) of known SEIs
        self.hash_failures = 0
        self.violations = []  # recoverable conformance errors (skipped NALs)

    def decode_stream(self, data: bytes, max_frames: Optional[int] = None):
        """Generator of DecodedFrame in output order."""
        from turingcodec_tpu_torch.decode.violations import Abort, Violation
        cur_slices = []  # (sh, rbsp, data_bit_pos)
        for nal in iter_nal_units(data):
            nut = nal.nal_unit_type
            br = BitReader(nal.rbsp)
            try:
                if nut == T.NalUnitType.VPS_NUT:
                    v = parse_vps(br)
                    self.ps.vps[v.vps_video_parameter_set_id] = v
                    continue
                elif nut == T.NalUnitType.SPS_NUT:
                    s = parse_sps(br)
                    self.ps.sps[s.sps_seq_parameter_set_id] = s
                    continue
                elif nut == T.NalUnitType.PPS_NUT:
                    p = parse_pps(br)
                    self.ps.pps[p.pps_pic_parameter_set_id] = p
                    continue
            except Abort:
                raise
            except (Violation, EOFError, KeyError, ValueError) as e:
                # malformed parameter set: record and skip (Violation.h
                # robustness semantics)
                self.violations.append(f"{T.NalUnitType(nut).name}: {e}")
                continue
            if T.is_vcl(nut):
                try:
                    sh = parse_slice_segment_header(
                        br, nut, nal.temporal_id, self.ps)
                except Abort:
                    raise
                except (Violation, EOFError, KeyError, ValueError,
                        IndexError) as e:
                    self.violations.append(
                        f"slice({T.NalUnitType(nut).name}): {e}")
                    continue
                if sh.first_slice_segment_in_pic_flag and cur_slices:
                    for f in self._finish_picture(cur_slices):
                        yield f
                        self.frame_count += 1
                        if max_frames and self.frame_count >= max_frames:
                            return
                    cur_slices = []
                cur_slices.append((sh, nal.rbsp, (br.pos + 7) & ~7))
            elif nut in (T.NalUnitType.PREFIX_SEI_NUT,
                         T.NalUnitType.SUFFIX_SEI_NUT):
                from turingcodec_tpu_torch.hevc.sei import (parse_sei_rbsp,
                                                      parse_structured)
                try:
                    msgs = parse_sei_rbsp(nal.rbsp)
                    self._pending_sei.extend(msgs)
                    for m in msgs:
                        s = parse_structured(m)
                        if s is not None:
                            self.sei_log.append((m.payload_type, s))
                except Exception:
                    pass  # malformed SEI is non-fatal
            elif nut in (T.NalUnitType.EOS_NUT, T.NalUnitType.EOB_NUT):
                if cur_slices:
                    for f in self._finish_picture(cur_slices):
                        yield f
                        self.frame_count += 1
                    cur_slices = []
                if self.dpb:
                    for p in self.dpb.flush():
                        yield DecodedFrame(p.poc, p.planes, getattr(p, "hash_ok", None))
                        self.frame_count += 1
                self.first_picture = True
        if cur_slices:
            for f in self._finish_picture(cur_slices):
                yield f
                self.frame_count += 1
                if max_frames and self.frame_count >= max_frames:
                    return
        if self.dpb:
            for p in self.dpb.flush():
                yield DecodedFrame(p.poc, p.planes, getattr(p, "hash_ok", None))
                self.frame_count += 1
                if max_frames and self.frame_count >= max_frames:
                    return

    # ------------------------------------------------------------------
    def _finish_picture(self, slices) -> List[DecodedFrame]:
        """One picture's parse, reconstruction, hash check and DPB
        update (the trace's dec.finish span, named by the POC)."""
        with TRACE.root("dec.finish"):
            sh0 = slices[0][0]
            nut = sh0.nal_unit_type
            sps, pps = self.ps.activate(sh0.slice_pic_parameter_set_id)

            if self.dpb is None or self.dpb.sps is not sps:
                self.dpb = Dpb(sps)
            key = (id(sps), id(pps))
            if self._geom_key != key:
                self.geom = PictureGeometry(sps, pps)
                self._geom_key = key

            # RASL pictures after a CRA that starts the sequence are skipped
            if T.is_irap(nut):
                no_rasl_output = (self.first_picture or T.is_idr(nut)
                                  or T.is_bla(nut))
                self.skip_rasl = no_rasl_output and not T.is_idr(nut)
                if T.is_idr(nut) or T.is_bla(nut):
                    self.skip_rasl = True
            if T.is_rasl(nut) and self.skip_rasl:
                return []
            if T.is_irap(nut):
                pass
            elif not T.is_rasl(nut):
                self.skip_rasl = False

            poc = self.dpb.derive_poc(sh0, self.first_picture)
            TRACE.set_picture(poc)
            self.first_picture = False
            self.dpb.apply_rps(sh0, poc)

            with TRACE.span("dec.parse"):
                plan = PicturePlan(sps, pps)
                # (ContextPool, last_cu_qp) across dependent segments
                dss_state = None
                slice_number = -1
                prev_indep = None
                for (sh, rbsp, bitpos) in slices:
                    if not sh.dependent_slice_segment_flag:
                        slice_number += 1
                        plan.slice_headers.append(sh)
                        prev_indep = sh
                    elif prev_indep is not None:
                        _inherit_slice_header(sh, prev_indep)
                    self.dpb.build_ref_lists(sh)
                    hook = None
                    if not sh.is_i:
                        hook = InterDeriver(plan, self.geom, sh, self.dpb, poc)
                    try:
                        dss_state = parse_slice_segment_data(
                            plan, self.geom, sh, rbsp, bitpos, slice_number,
                            hook, dss_state=dss_state)
                    except Violation:
                        raise
                    except Exception as e:
                        # any parse failure on a corrupt stream is a
                        # conformance violation, never a raw crash (the
                        # reference's StreamAbort wrapping, Read.hpp:104-113
                        # / Violation.h)
                        from turingcodec_tpu_torch.decode.violations import (
                            Violation as V)
                        raise V("7.3.8.1",
                                f"slice segment data parse failed: "
                                f"{type(e).__name__}: {e}") from e

            # reconstruction (ref lists of the last slice are fine for single-
            # slice pictures; multi-slice pictures re-derive per slice)
            with TRACE.span("dec.recon"):
                planes = self._reconstruct(plan, sh0, poc)

            # decoded_picture_hash SEI verification (StateDecode.h:139-157
            # parity)
            hash_ok = None
            with TRACE.span("dec.hash"):
                if self._pending_sei:
                    from turingcodec_tpu_torch.hevc import sei as sei_mod
                    for m in self._pending_sei:
                        if m.payload_type == sei_mod.SEI_DECODED_PICTURE_HASH:
                            hash_ok = sei_mod.verify_decoded_picture_hash(
                                m, planes, sps.bit_depth_y)
                            if not hash_ok:
                                self.hash_failures += 1
                    self._pending_sei = []

            with TRACE.span("dec.dpb"):
                pic = DecodedPicture(poc=poc, temporal_id=sh0.temporal_id,
                                     nal_unit_type=nut)
                pic.planes = planes
                pic.plan = plan
                pic.is_reference = True
                pic.hash_ok = hash_ok
                out = self.dpb.picture_done(pic, sh0)
                return [DecodedFrame(p.poc, p.planes,
                                     getattr(p, "hash_ok", None))
                        for p in out]

    def _reconstruct(self, plan, sh0, poc):
        # per-slice ref lists: rebuild for reconstruction (predict_pu pulls
        # from these); for multi-slice this would need per-CU slice lookup —
        # handled by reconstructing with each slice's lists
        recon = self.reconstructor_cls(plan, self.geom,
                                       self._ref_lists_for(plan),
                                       device=self.device)
        return recon.run()

    def _ref_lists_for(self, plan):
        # Single set of lists per picture: re-derive from the first slice
        # (true multi-slice support: per-slice lists keyed by slice_idx TODO)
        if plan.slice_headers:
            self.dpb.build_ref_lists(plan.slice_headers[0])
        return self.dpb.ref_pic_list


def decode_to_yuv(data: bytes, max_frames: Optional[int] = None,
                  out_path: Optional[str] = None, bit_depth: int = 8,
                  device="cuda"):
    """Decode a stream; returns (md5_hex, frame_count). Writes YUV if path.
    device: see Decoder."""
    dec = Decoder(device=device)
    md5 = hashlib.md5()
    n = 0
    fh = open(out_path, "wb") if out_path else None
    try:
        for frame in dec.decode_stream(data, max_frames):
            for plane in frame.planes:
                if bit_depth == 8:
                    b = plane.astype(np.uint8).tobytes()
                else:
                    b = plane.astype("<u2").tobytes()
                md5.update(b)
                if fh:
                    fh.write(b)
            n += 1
    finally:
        if fh:
            fh.close()
    return md5.hexdigest(), n
