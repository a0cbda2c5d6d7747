"""Per-picture reconstruction driver: replays the decode-order CU/TU walk
from the plan, producing the reconstructed picture (pre-loop-filter), then
applies deblock + SAO.

Parity reference: turing/Decode.h reconstruction flow + StatePictures.h
preCtu/postCtu loop-filter sequencing.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from turingcodec_tpu_torch.hevc import types as T
from turingcodec_tpu_torch.hevc.tables import chroma_qp_from_luma
from turingcodec_tpu_torch.decode.deblock_vec import deblock_picture_vec as deblock_picture
from turingcodec_tpu_torch.decode.inter_pred import derive_wp_tables, predict_pu
from turingcodec_tpu_torch.decode.plan import PicturePlan
from turingcodec_tpu_torch.decode.reconstruct import (
    ReferenceSampleBuilder,
    dequant_block,
    filter_reference_samples,
    intra_predict,
    inverse_transform,
    transform_skip_residual,
)
from turingcodec_tpu_torch.decode.sao import sao_picture


def _pu_geometry(cu, part_mode):
    x0, y0 = cu.x0, cu.y0
    s = 1 << cu.log2_size
    h = s >> 1
    q = s >> 2
    return {
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


def _staged(name: str) -> bool:
    """Whether the TURING_TPU_DEVICE_<name> switch selects a staged device
    stage (read only when the reconstructor has a device)."""
    return bool(os.environ.get(f"TURING_TPU_DEVICE_{name}"))


class PictureReconstructor:
    """device: None runs the host path (the TURING_TPU_DEVICE_* switches
    are not read). A torch device runs the chained device pipeline
    (decode/device_pipeline.py), or, when any of TURING_TPU_DEVICE_RECON,
    _DEBLOCK or _SAO is set, those staged stages on the device and the
    rest on the host."""

    def __init__(self, plan: PicturePlan, geom, ref_lists, device=None):
        self.plan = plan
        self.geom = geom
        self.ref_lists = ref_lists
        self.device = device
        sps = plan.sps
        w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        cw, ch = w // sps.sub_width_c, h // sps.sub_height_c
        self.ry = np.zeros((h, w), np.int16)
        self.rcb = np.zeros((ch, cw), np.int16)
        self.rcr = np.zeros((ch, cw), np.int16)
        self.refs = ReferenceSampleBuilder(plan, geom)
        self.bd_y = sps.bit_depth_y
        self.bd_c = sps.bit_depth_c
        # scaling factors (None = flat 16)
        self.scaling = None
        if sps.scaling_list_enabled_flag:
            from turingcodec_tpu_torch.hevc.scaling import build_scaling_factors
            sld = plan.pps.scaling_list_data or sps.scaling_list_data
            self.scaling = build_scaling_factors(sld)

    use_batched_inter = True  # grouped vector MC/IDCT (bit-exact w/ scalar)

    # ------------------------------------------------------------------
    def run(self):
        plan = self.plan
        self.wp_tables = [derive_wp_tables(sh, plan.sps)
                          for sh in plan.slice_headers]
        if any(w is not None for w in self.wp_tables):
            # weighted prediction: scalar per-PU path (spec 8.5.3.3.4.3),
            # outside the device pipeline's envelope
            if self.device is not None:
                from turingcodec_tpu_torch.decode import device_pipeline
                device_pipeline.left_to_host()
            for cu in plan.cu_list:
                if cu.pcm:
                    self._recon_pcm(cu)
                elif cu.pred_mode == 0:
                    self._recon_inter_cu(cu)
                else:
                    self._recon_intra_cu(cu)
            return self._loop_filters()
        if self.use_batched_inter:
            from turingcodec_tpu_torch import native
            from turingcodec_tpu_torch.decode.recon_vec import reconstruct_inter_batch
            recon = [self.ry, self.rcb, self.rcr]
            staged = self.device is not None and any(
                _staged(k) for k in ("RECON", "DEBLOCK", "SAO"))
            if self.device is not None and not staged:
                # chained device pipeline: MC -> residual -> (host intra)
                # -> deblock -> SAO, one device->host pull per picture
                from turingcodec_tpu_torch.decode.device_pipeline import (
                    decode_picture_device)
                out = decode_picture_device(self, self.device)
                if out is not None:
                    return out
            if staged and _staged("RECON"):
                from turingcodec_tpu_torch.decode.device_recon import (
                    reconstruct_inter_device)
                reconstruct_inter_device(plan, self.geom, self.ref_lists,
                                         recon, self.device)
            else:
                reconstruct_inter_batch(plan, self.geom, self.ref_lists,
                                        recon)
            if not native.intra_recon(self):
                for cu in plan.cu_list:
                    if cu.pcm:
                        self._recon_pcm(cu)
                    elif cu.pred_mode == 1:
                        self._recon_intra_cu(cu)
            return self._loop_filters()
        for cu in plan.cu_list:
            if cu.pcm:
                self._recon_pcm(cu)
            elif cu.pred_mode == 0:
                self._recon_inter_cu(cu)
            else:
                self._recon_intra_cu(cu)
        return self._loop_filters()

    def _loop_filters(self):
        plan = self.plan
        on_device = self.device is not None
        if on_device and _staged("DEBLOCK"):
            from turingcodec_tpu_torch.ops.deblock import (
                deblock_picture_device)
            deblock_picture_device(plan, self.geom, self.ry, self.rcb,
                                   self.rcr, self.device)
        else:
            deblock_picture(plan, self.geom, self.ry, self.rcb, self.rcr)
        if any(sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
               for sh in plan.slice_headers):
            if on_device and _staged("SAO"):
                from turingcodec_tpu_torch.ops.sao import sao_picture_device
                planes = sao_picture_device(
                    plan, self.geom, [self.ry, self.rcb, self.rcr],
                    self.device)
            else:
                planes = sao_picture(plan, self.geom,
                                     [self.ry, self.rcb, self.rcr])
            self.ry, self.rcb, self.rcr = planes
        return [self.ry, self.rcb, self.rcr]

    # ------------------------------------------------------------------
    def _recon_pcm(self, cu):
        for (x0, y0, log2, ys, cbs, crs) in self.plan.pcm_samples:
            if x0 == cu.x0 and y0 == cu.y0:
                n = 1 << log2
                self.ry[y0:y0 + n, x0:x0 + n] = ys
                if self.plan.sps.chroma_array_type:
                    c = n >> 1
                    self.rcb[y0 >> 1:(y0 >> 1) + c, x0 >> 1:(x0 >> 1) + c] = cbs
                    self.rcr[y0 >> 1:(y0 >> 1) + c, x0 >> 1:(x0 >> 1) + c] = crs
                return

    # ------------------------------------------------------------------
    def _residual(self, plane_coeffs, x, y, log2, qp, bit_depth, use_dst,
                  tskip, bypass, size_id_chroma=None, matrix_id=None):
        n = 1 << log2
        coeffs = plane_coeffs[y:y + n, x:x + n]
        if not coeffs.any():
            return None
        if bypass:
            return coeffs.astype(np.int32)
        sm = None
        if self.scaling is not None:
            sm = self.scaling.get((log2, matrix_id)) if matrix_id is not None else None
        d = dequant_block(coeffs, qp, bit_depth, log2, sm)
        if tskip:
            return transform_skip_residual(d, bit_depth)
        return inverse_transform(d, bit_depth, use_dst)

    def _luma_qp(self, cu):
        return int(self.plan.qp_y[cu.y0 >> 2, cu.x0 >> 2]) + \
            self.plan.sps.qp_bd_offset_y

    def _chroma_qp(self, cu, c_idx):
        sps, pps = self.plan.sps, self.plan.pps
        sh = self.plan.slice_headers[int(
            self.plan.slice_idx[cu.y0 >> sps.ctb_log2_size_y,
                                cu.x0 >> sps.ctb_log2_size_y])]
        off = (pps.pps_cb_qp_offset + sh.slice_cb_qp_offset if c_idx == 1
               else pps.pps_cr_qp_offset + sh.slice_cr_qp_offset)
        qp_y = int(self.plan.qp_y[cu.y0 >> 2, cu.x0 >> 2])
        qpi = max(-sps.qp_bd_offset_c, min(57, qp_y + off))
        return chroma_qp_from_luma(qpi, sps.chroma_format_idc) + sps.qp_bd_offset_c

    # ------------------------------------------------------------------
    def _recon_inter_cu(self, cu):
        plan = self.plan
        max_y = (1 << self.bd_y) - 1
        cl2 = plan.sps.ctb_log2_size_y
        wp = self.wp_tables[int(plan.slice_idx[cu.y0 >> cl2, cu.x0 >> cl2])] \
            if getattr(self, "wp_tables", None) else None
        for (px, py, pw, ph) in _pu_geometry(cu, cu.part_mode):
            pred_y, pred_cb, pred_cr = predict_pu(
                plan, self.ref_lists, px, py, pw, ph, self.bd_y, self.bd_c,
                wp=wp)
            self.ry[py:py + ph, px:px + pw] = pred_y
            self.rcb[py >> 1:(py + ph) >> 1, px >> 1:(px + pw) >> 1] = pred_cb
            self.rcr[py >> 1:(py + ph) >> 1, px >> 1:(px + pw) >> 1] = pred_cr
        if cu.skip:
            return
        qp_y = self._luma_qp(cu)
        qp_cb = self._chroma_qp(cu, 1)
        qp_cr = self._chroma_qp(cu, 2)
        for (x0, y0, log2, blk_idx, xb, yb, cbf_y, cbf_cb, cbf_cr) in cu.tus:
            bx, by = x0 >> 2, y0 >> 2
            if cbf_y:
                r = self._residual(plan.coeff_y, x0, y0, log2, qp_y, self.bd_y,
                                   False, plan.transform_skip_y[by, bx],
                                   cu.tq_bypass, matrix_id=3)
                if r is not None:
                    n = 1 << log2
                    blk = self.ry[y0:y0 + n, x0:x0 + n].astype(np.int32) + r
                    self.ry[y0:y0 + n, x0:x0 + n] = np.clip(blk, 0, max_y)
            self._chroma_residual(cu, x0, y0, log2, blk_idx, xb, yb,
                                  cbf_cb, cbf_cr, qp_cb, qp_cr, inter=True)

    def _chroma_residual(self, cu, x0, y0, log2, blk_idx, xb, yb,
                         cbf_cb, cbf_cr, qp_cb, qp_cr, inter):
        plan = self.plan
        max_c = (1 << self.bd_c) - 1
        if log2 > 2:
            cx, cy, clog2 = x0 >> 1, y0 >> 1, log2 - 1
        elif blk_idx == 3:
            cx, cy, clog2 = xb >> 1, yb >> 1, 2
        else:
            return
        mid = 4 if inter else 1  # matrix id base (inter cb=4, cr=5; intra 1,2)
        for (cbf, plane, qp, msk, mat) in (
                (cbf_cb, self.rcb, qp_cb, plan.transform_skip_cb, mid),
                (cbf_cr, self.rcr, qp_cr, plan.transform_skip_cr, mid + 1)):
            if not cbf:
                continue
            ts = msk[cy >> 1, cx >> 1]
            coeffs = plan.coeff_cb if plane is self.rcb else plan.coeff_cr
            r = self._residual(coeffs, cx, cy, clog2, qp, self.bd_c,
                               False, ts, cu.tq_bypass, matrix_id=mat)
            if r is not None:
                n = 1 << clog2
                blk = plane[cy:cy + n, cx:cx + n].astype(np.int32) + r
                plane[cy:cy + n, cx:cx + n] = np.clip(blk, 0, max_c)

    # ------------------------------------------------------------------
    def _native_intra_ok(self, cu):
        """Gate for the native intra-TU path: the C++ core covers the common
        case (no multi-slice/tile/CIP bounds, flat scaling, no transform
        skip, no transquant bypass)."""
        if cu.tq_bypass or self.scaling is not None:
            return False
        if self._zscan32 is None:
            from turingcodec_tpu_torch import native
            lib = native.get_lib()
            if lib is None or self.refs._complex_bounds():
                self._zscan32 = False
            else:
                self._zscan32 = np.ascontiguousarray(self.geom.zscan,
                                                     np.int32)
                # cache the raw function + buffer addresses: ~56k calls per
                # second of video makes per-call ctypes sugar measurable
                self._nfn = lib.tc_intra_tu
                self._ptr = {
                    id(self.ry): self.ry.ctypes.data,
                    id(self.rcb): self.rcb.ctypes.data,
                    id(self.rcr): self.rcr.ctypes.data,
                }
                p = self.plan
                self._cptr = {0: p.coeff_y.ctypes.data,
                              1: p.coeff_cb.ctypes.data,
                              2: p.coeff_cr.ctypes.data}
                self._zptr = self._zscan32.ctypes.data
                self._zw = self._zscan32.shape[1]
        return self._zscan32 is not False

    _zscan32 = None

    def _recon_intra_cu(self, cu):
        plan = self.plan
        sps = plan.sps
        max_y = (1 << self.bd_y) - 1
        max_c = (1 << self.bd_c) - 1
        qp_y = self._luma_qp(cu)
        qp_cb = self._chroma_qp(cu, 1)
        qp_cr = self._chroma_qp(cu, 2)
        use_native = self._native_intra_ok(cu)
        strong = int(sps.strong_intra_smoothing_enabled_flag != 0)
        if use_native:
            nfn = self._nfn
            zptr, zw = self._zptr, self._zw
            pw_y, ph_y = self.ry.shape[1], self.ry.shape[0]
            pw_c, ph_c = self.rcb.shape[1], self.rcb.shape[0]
        tus = cu.tus if cu.tus else [
            (cu.x0, cu.y0, cu.log2_size, 0, cu.x0, cu.y0, 0, 0, 0)]
        for (x0, y0, log2, blk_idx, xb, yb, cbf_y, cbf_cb, cbf_cr) in tus:
            n = 1 << log2
            bx, by = x0 >> 2, y0 >> 2
            mode = int(plan.intra_mode_y[by, bx])
            if use_native and not plan.transform_skip_y[by, bx]:
                nfn(self._ptr[id(self.ry)], pw_y, ph_y, zptr, zw, x0, y0,
                    n, 0, 1, self.bd_y, mode, strong, self._cptr[0],
                    int(cbf_y), qp_y, int(log2 == 2))
            else:
                # luma prediction (pure-Python oracle path)
                rt, rl, corner = self.refs.build(self.ry, x0, y0, n, 0,
                                                 self.bd_y)
                frt, frl, fc = filter_reference_samples(
                    rt, rl, corner, n, mode, strong, self.bd_y)
                pred = intra_predict(mode, frt, frl, fc, n, 0, self.bd_y,
                                     disable_edge_filters=False)
                if cbf_y:
                    use_dst = log2 == 2
                    r = self._residual(plan.coeff_y, x0, y0, log2, qp_y,
                                       self.bd_y, use_dst,
                                       plan.transform_skip_y[by, bx],
                                       cu.tq_bypass, matrix_id=0)
                    if r is not None:
                        pred = pred + r
                self.ry[y0:y0 + n, x0:x0 + n] = np.clip(pred, 0, max_y)

            # chroma at this leaf?
            if log2 > 2:
                cx, cy, cn = x0 >> 1, y0 >> 1, n >> 1
            elif blk_idx == 3:
                cx, cy, cn = xb >> 1, yb >> 1, 4
            else:
                continue
            mode_c = int(plan.intra_mode_c[(cy << 1) >> 2, (cx << 1) >> 2])
            for (plane, qp, coeffs, cbf, msk, mat) in (
                    (self.rcb, qp_cb, plan.coeff_cb, cbf_cb,
                     plan.transform_skip_cb, 1),
                    (self.rcr, qp_cr, plan.coeff_cr, cbf_cr,
                     plan.transform_skip_cr, 2)):
                if use_native and not msk[cy >> 1, cx >> 1]:
                    nfn(self._ptr[id(plane)], pw_c, ph_c, zptr, zw, cx, cy,
                        cn, 1, 2, self.bd_c, mode_c, strong,
                        self._cptr[mat], int(cbf), qp, 0)
                    continue
                rt, rl, corner = self.refs.build(plane, cx, cy, cn, 1,
                                                 self.bd_c)
                predc = intra_predict(mode_c, rt, rl, corner, cn, 1,
                                      self.bd_c)
                if cbf:
                    r = self._residual(coeffs, cx, cy, cn.bit_length() - 1,
                                       qp, self.bd_c, False,
                                       msk[cy >> 1, cx >> 1], cu.tq_bypass,
                                       matrix_id=mat)
                    if r is not None:
                        predc = predc + r
                plane[cy:cy + cn, cx:cx + cn] = np.clip(predc, 0, max_c)
