"""The encoder's tool configurations (AQ per CTB and per CU, CBR rate
control at CTU and picture level with HRD signalling, shot-change IDR
placement, tiles, independent and dependent slices, transform skip) at the
main path's operating point, with goldens pinned from the JAX package: one
table of rows shared by chip_smoke.py's card phase and the CPU tests
(tests/test_torch_encoder_tools*.py).

Each row of ROWS gives its EncoderConfig overrides on top of
OPERATING_POINT (chip_smoke.py's main path: QP 30, one RD candidate,
search range 32, low delay, RDOQ + SDH, SAO on), its input, and the
4-byte md5 prefixes of the bitstream and of the decoded planes of its card
input (hashes()). The goldens are the JAX package's encoder (its analysis
stage on, TURING_TPU_DEVICE_ENC=1) and decoder on the same card input
(tests/test_torch_encoder_tools.py re-derives them in a slow test).
reach() checks that a row's stream reaches its tool.

Inputs: the main path's frames (tests/streams/vfy_sweep.hevc decoded,
upscaled 3x by nearest neighbour to 1920x1080) for the AQ and rate-control
rows; a 128x256 crop of them for the tile, slice and transform-skip rows,
whose encodes run the pure-Python CTU searcher; a static 640x360 gradient
scene with a cut at frame 13 for the shot-change row. Each row also has a
small input for the CPU tests (`small=True`).
"""
from __future__ import annotations

import hashlib
import time
from typing import NamedTuple

import numpy as np

from turingcodec_tpu_torch.tools.device_enc_check import check

# chip_smoke.py's main path (tools/device_enc_check.py::encode) with SAO
# on, the encoder's default
OPERATING_POINT = dict(qp=30, rd_candidates=1, search_range=32, gop_m=1,
                       rdoq=True, sdh=True, sao=True)
CUT_AT = 13


class Row(NamedTuple):
    name: str
    overrides: dict
    source: str          # "main": vfy_sweep, "cut": the scene with a cut
    card: tuple          # (x, y, w, h, frames) of the card input
    small: tuple         # the same for the CPU tests
    golden: tuple        # (bits4, recon4) of the card input, from JAX


_CBR = dict(bitrate=1.5e6, frame_rate=24.0)
_MAIN = (0, 0, 1920, 1080, 3)
_MAIN_SMALL = (224, 96, 192, 128, 3)
_CROP = (768, 384, 128, 256, 2)
ROWS = [
    Row("aq-ctb", dict(aq_strength=1.0, aq_depth=0), "main", _MAIN,
        _MAIN_SMALL, ("1747846d", "9d8bf47a")),
    Row("aq-cu", dict(aq_strength=1.0, aq_depth=2), "main", _MAIN,
        _MAIN_SMALL, ("cc6557f2", "88b0dbe0")),
    Row("cbr-ctu-hrd", dict(_CBR, ctu_rc=True, sei_hrd_timing=True),
        "main", _MAIN, _MAIN_SMALL, ("223bdc93", "e4b5248b")),
    Row("cbr-picture", dict(_CBR, ctu_rc=False), "main", _MAIN,
        _MAIN_SMALL, ("3d6f9f8d", "4a2582f5")),
    Row("scd-gop4", dict(shot_change=True, gop_m=4, qp=34), "cut",
        (0, 0, 640, 360, 30), (0, 0, 96, 64, 30),
        ("26ce87b2", "ca8501ef")),
    Row("tiles-2x2", dict(tile_cols=2, tile_rows=2, wpp=False), "main",
        _CROP, (224, 96, 128, 128, 2), ("c2898ccf", "a19bbb7d")),
    Row("slices-4", dict(slices=4, wpp=False), "main", _CROP,
        (224, 64, 64, 256, 2), ("5fb49f87", "241b29bd")),
    Row("dep-slices-4", dict(slices=4, wpp=False, dependent_slices=True),
        "main", _CROP, (224, 64, 64, 256, 2), ("9ed3fafb", "0b843b25")),
    Row("tskip", dict(tskip=True), "main", _CROP, (224, 96, 64, 64, 2),
        ("eaf4a07e", "eab07d23")),
]
BY_NAME = {row.name: row for row in ROWS}


def cut_frames(n: int, w: int, h: int, cut: int = CUT_AT):
    """A static gradient scene and its inverse from frame `cut` on
    (tests/test_gop_scd.py::_frames with cut_at): the histogram-based
    detector (SCDetection.h) sees one spike in a quiet window."""
    base = np.add.outer(np.arange(h + 32), np.arange(w + 32)) \
        .astype(np.int16) % 200
    alt = (255 - base // 2).astype(np.int16)
    out = []
    for i in range(n):
        src = alt if i >= cut else base
        out.append([np.ascontiguousarray(src[:h, :w]),
                    np.ascontiguousarray(src[:h // 2, :w // 2]),
                    np.ascontiguousarray(src[16:16 + h // 2, :w // 2])])
    return out


def row_input(name: str, clip=None, small: bool = False):
    """The row's frames: a crop of `clip` (device_enc_check.decode_inputs:
    the main path's frames at upscale 3, at upscale 1 for small inputs) or
    the scene with a cut."""
    row = BY_NAME[name]
    x, y, w, h, n = row.small if small else row.card
    if row.source == "cut":
        return cut_frames(n, w, h)
    check(clip is not None and len(clip) >= n,
          f"{name}: needs {n} frames of the clip")
    return [[np.ascontiguousarray(p[(y >> s):(y + h) >> s,
                                    (x >> s):(x + w) >> s])
             for p, s in zip(fr, (0, 1, 1))] for fr in clip[:n]]


def config(name: str, frames) -> dict:
    """EncoderConfig keyword arguments of the row for `frames` (no device:
    the JAX package's EncoderConfig has none)."""
    h, w = frames[0][0].shape
    return dict(OPERATING_POINT, width=w, height=h,
                **BY_NAME[name].overrides)


def encode(enc, frames):
    """Push `frames` through `enc` (an Encoder of either package): returns
    (bitstream, the plan of each picture in output order, seconds). Plans
    are read from the encoder after each picture, as tests/test_rate_
    invariant.py reads them; with one picture per push (low delay) each
    is its own."""
    out = [enc.headers()]
    plans = []
    t0 = time.perf_counter()
    for f in frames:
        for (_i, nal, _r) in enc.push_frame([p.copy() for p in f]):
            out.append(nal)
            plans.append(enc._last_plan)
    for (_i, nal, _r) in enc.flush():
        out.append(nal)
        plans.append(enc._last_plan)
    return b"".join(out), plans, time.perf_counter() - t0


def encode_row(name: str, frames, device=None):
    """The row encoded with the port: (bitstream, plans, seconds)."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    return encode(Encoder(EncoderConfig(**config(name, frames),
                                        device=device)), frames)


def stream_facts(bitstream: bytes) -> dict:
    """What the headers of `bitstream` say: IDR NAL units, tiles per
    picture (the last PPS), and per picture its slice segments, dependent
    segments and the SliceQpY of each independent one."""
    from turingcodec_tpu_torch.bitstream.reader import (BitReader,
                                                        iter_nal_units)
    from turingcodec_tpu_torch.hevc import types as T
    from turingcodec_tpu_torch.hevc.header_syntax import (
        parse_pps, parse_slice_segment_header, parse_sps, parse_vps)
    from turingcodec_tpu_torch.hevc.params import ParamSets
    ps = ParamSets()
    idr, tiles, pics = 0, 1, []
    for nal in iter_nal_units(bitstream):
        t = nal.nal_unit_type
        br = BitReader(nal.rbsp)
        if t == T.NalUnitType.VPS_NUT:
            v = parse_vps(br)
            ps.vps[v.vps_video_parameter_set_id] = v
        elif t == T.NalUnitType.SPS_NUT:
            s = parse_sps(br)
            ps.sps[s.sps_seq_parameter_set_id] = s
        elif t == T.NalUnitType.PPS_NUT:
            p = parse_pps(br)
            ps.pps[p.pps_pic_parameter_set_id] = p
            tiles = ((p.num_tile_columns_minus1 + 1)
                     * (p.num_tile_rows_minus1 + 1)
                     if p.tiles_enabled_flag else 1)
        elif T.is_vcl(t):
            idr += T.is_idr(t)
            sh = parse_slice_segment_header(br, t, nal.temporal_id, ps)
            if sh.first_slice_segment_in_pic_flag:
                pics.append(dict(segments=0, dependent=0, qps=[]))
            pics[-1]["segments"] += 1
            if sh.dependent_slice_segment_flag:
                pics[-1]["dependent"] += 1
            else:
                pics[-1]["qps"].append(sh.slice_qp_y)
    return dict(idr=idr, tiles=tiles, pictures=pics)


def reach(name: str, bitstream: bytes, plans) -> str:
    """Check that the row's stream reaches its tool (a picture with more
    than one QpY under AQ or CTU rate control; a slice QP off the
    configured one, or differing between pictures, under picture-level
    rate control; two IDR NAL units; 4 tiles; 4 slice segments a picture,
    3 of them dependent where asked; a transform-skip TB); returns what it
    shows."""
    facts = stream_facts(bitstream)
    pics = facts["pictures"]
    qp = BY_NAME[name].overrides.get("qp", OPERATING_POINT["qp"])
    if name in ("aq-ctb", "aq-cu", "cbr-ctu-hrd"):
        most = max(len(np.unique(p.qp_y)) for p in plans)
        check(most > 1, f"{name}: one QpY per picture")
        return f"up to {most} distinct QpY in a picture"
    if name == "cbr-picture":
        qps = [q for p in pics for q in p["qps"]]
        check(len(set(qps)) > 1 or qps[0] != qp,
              f"{name}: every slice QP is {qp}")
        return f"slice QPs {qps}"
    if name == "scd-gop4":
        check(facts["idr"] == 2, f"{name}: {facts['idr']} IDR NAL units")
        return "2 IDR NAL units"
    if name == "tiles-2x2":
        check(facts["tiles"] == 4, f"{name}: {facts['tiles']} tiles")
        return "4 tiles"
    if name in ("slices-4", "dep-slices-4"):
        dep = 3 if name == "dep-slices-4" else 0
        check(all(p["segments"] == 4 and p["dependent"] == dep
                  for p in pics), f"{name}: slice segments {pics}")
        return f"4 slice segments per picture, {dep} dependent"
    if name == "tskip":
        n = sum(int(np.count_nonzero(getattr(p, f"transform_skip_{c}")))
                for p in plans for c in ("y", "cb", "cr"))
        check(n > 0, f"{name}: no transform-skip TB")
        return f"{n} 4x4 blocks under transform skip"
    raise KeyError(name)


def decode(bitstream: bytes, device=None):
    """Decode with the port: (the planes of each frame, the Decoder)."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    dec = Decoder(device=device)
    return [[np.asarray(p) for p in f.planes]
            for f in dec.decode_stream(bitstream)], dec


def hashes(bitstream: bytes, frames) -> tuple:
    """(bits4, recon4): 4-byte md5 prefixes of the bitstream and of the
    decoded 8-bit planes, frame by frame."""
    md5 = hashlib.md5()
    for planes in frames:
        for p in planes:
            md5.update(np.asarray(p).astype(np.uint8).tobytes())
    return hashlib.md5(bitstream).hexdigest()[:8], md5.hexdigest()[:8]

