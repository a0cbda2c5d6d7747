"""Port twins of the JAX package's stream-parser tests, moved from the
absent caminandes clip onto tests/streams:

- tests/test_bitstream.py: emulation prevention, Exp-Golomb and fixed
  reads, more_rbsp_data, and NAL iteration over vfy_sweep.hevc equal to
  the JAX package's;
- tests/test_sei_breadth.py: every SEI payload type the reference parses
  has a typed parser, nesting recurses, unknown and truncated payloads
  are skip-safe; and every SEI message of vfy_fullsei.hevc parses as the
  JAX package parses it;
- tests/test_headers.py: SPS/PPS/slice-header parse and bit-exact
  re-serialisation on vfy_fullsei.hevc and ms_dep4.hevc, each field equal
  to the JAX package's parse of the same bytes; level derivation."""
import os

import numpy as np
import pytest

import turingcodec_tpu.bitstream.reader as jreader
import turingcodec_tpu.hevc.header_syntax as jhs
import turingcodec_tpu.hevc.params as jparams
import turingcodec_tpu.hevc.sei as jsei
from turingcodec_tpu_torch.bitstream.reader import (
    BitReader, insert_emulation_prevention, iter_nal_units,
    remove_emulation_prevention)
from turingcodec_tpu_torch.bitstream.writer import BitWriter
from turingcodec_tpu_torch.hevc import header_syntax as hs
from turingcodec_tpu_torch.hevc import params, sei
from turingcodec_tpu_torch.hevc import types as T

STREAMS = os.path.join(os.path.dirname(__file__), "streams")


def _data(name):
    return open(os.path.join(STREAMS, name), "rb").read()


def _plain(x):
    """A parsed structure as plain values (either package's classes), so
    the two packages' parses compare field by field."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__dict__"):
        return {k: _plain(v) for k, v in vars(x).items()}
    return int(x) if isinstance(x, np.integer) else x


# -- tests/test_bitstream.py -------------------------------------------

def test_ep3_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(50):
        raw = bytes(rng.integers(0, 4, size=rng.integers(1, 200))
                    .astype(np.uint8))
        ebsp = insert_emulation_prevention(raw)
        assert remove_emulation_prevention(ebsp) == raw
        assert ebsp == jreader.insert_emulation_prevention(raw)
        # no 00 00 0[0-2] in an EBSP (00 00 03 is the escape)
        for i in range(len(ebsp) - 2):
            if ebsp[i] == 0 and ebsp[i + 1] == 0:
                assert ebsp[i + 2] >= 3


def test_ep3_specific():
    assert remove_emulation_prevention(b"\x00\x00\x03\x00") == b"\x00\x00\x00"
    assert remove_emulation_prevention(b"\x00\x00\x03\x01") == b"\x00\x00\x01"
    assert insert_emulation_prevention(b"\x00\x00\x00\x00") \
        == b"\x00\x00\x03\x00\x00"
    assert insert_emulation_prevention(b"\x00\x00\x03") == b"\x00\x00\x03\x03"


def test_bitreader_ue_se():
    bw = BitWriter()
    values = [0, 1, 2, 3, 4, 5, 100, 65535]
    for v in values:
        bw.ue(v)
    svalues = [0, 1, -1, 2, -2, 17, -100]
    for v in svalues:
        bw.se(v)
    bw.rbsp_trailing_bits()
    br = BitReader(bw.get_bytes())
    assert [br.ue() for _ in values] == values
    assert [br.se() for _ in svalues] == svalues


def test_bitreader_u():
    bw = BitWriter()
    bw.u(0x5, 3)
    bw.u(0x1234, 16)
    bw.u(1, 1)
    bw.u(0, 4)  # pad to byte
    br = BitReader(bw.get_bytes())
    assert br.u(3) == 5
    assert br.u(16) == 0x1234
    assert br.u(1) == 1


def test_more_rbsp_data():
    br = BitReader(b"\x80")  # just a stop bit
    assert not br.more_rbsp_data()
    br = BitReader(b"\xc0")  # one data bit + stop bit
    assert br.more_rbsp_data()
    assert br.u(1) == 1
    assert not br.more_rbsp_data()


def test_nal_iteration():
    """vfy_sweep.hevc: VPS, SPS, PPS, then 9 pictures of one slice each,
    each with its suffix decoded-picture-hash SEI; the JAX package
    iterates the same units with the same payloads."""
    data = _data("vfy_sweep.hevc")
    nals = list(iter_nal_units(data))
    assert len(nals) == 21
    assert [n.type_name for n in nals[:5]] == [
        "VPS_NUT", "SPS_NUT", "PPS_NUT", "IDR_W_RADL", "SUFFIX_SEI_NUT"]
    assert sum(T.is_vcl(n.nal_unit_type) for n in nals) == 9
    want = list(jreader.iter_nal_units(data))
    assert [(n.nal_unit_type, n.temporal_id, n.type_name, n.rbsp)
            for n in nals] == [(n.nal_unit_type, n.temporal_id,
                                n.type_name, n.rbsp) for n in want]


# -- tests/test_sei_breadth.py -----------------------------------------

def _pl(fn):
    bw = BitWriter()
    fn(bw)
    if bw.nbits:
        bw.u(0, 8 - bw.nbits)
    return bw.get_bytes()


def test_payload_type_coverage():
    # the reference's SyntaxSei.h table (prefix+suffix, minus reserved)
    ref_types = {0, 1, 2, 3, 4, 5, 6, 9, 15, 16, 17, 19, 22, 23, 45, 47,
                 128, 129, 130, 131, 132, 133, 134, 135, 136, 137, 138,
                 139, 140, 141, 142, 143, 144, 147, 160, 161, 162, 163,
                 164, 165, 166, 167, 168, 176, 177, 178, 179, 180}
    ours = set(sei._STRUCTURED_PARSERS) | {sei.SEI_DECODED_PICTURE_HASH}
    assert not ref_types - ours, sorted(ref_types - ours)
    assert set(sei._STRUCTURED_PARSERS) == set(jsei._STRUCTURED_PARSERS)


def test_simple_payload_parses():
    assert sei.parse_recovery_point(
        _pl(lambda b: (b.se(2), b.u(1, 1), b.u(0, 1)))) == {
        "recovery_poc_cnt": 2, "exact_match_flag": 1,
        "broken_link_flag": 0}
    assert sei.parse_content_light_level(b"\x03\xe8\x01\x90") == {
        "max_content_light_level": 1000,
        "max_pic_average_light_level": 400}
    assert sei.parse_frame_field_info(b"\x14")["ffinfo_pic_struct"] == 1
    d = sei.parse_display_orientation(
        _pl(lambda b: (b.u(0, 1), b.u(1, 1), b.u(0, 1),
                       b.u(90, 16), b.u(1, 1))))
    assert d["hor_flip"] == 1 and d["anticlockwise_rotation"] == 90
    assert sei.parse_region_refresh_info(b"\x80")[
        "refreshed_region_flag"] == 1
    tc = sei.parse_time_code(_pl(lambda b: (
        b.u(1, 2), b.u(1, 1), b.u(0, 1), b.u(0, 5), b.u(1, 1), b.u(0, 1),
        b.u(0, 1), b.u(7, 9), b.u(30, 6), b.u(12, 6), b.u(1, 5),
        b.u(0, 5))))
    assert tc["clock_ts"][0]["n_frames"] == 7
    assert tc["clock_ts"][0]["hours_value"] == 1


def _nesting(head):
    """A scalable_nesting payload: `head` writes its flags, then the
    alignment quirk and a nested recovery_point."""
    inner = sei.SeiMessage(6, _pl(lambda b: (b.se(0), b.u(1, 1),
                                             b.u(0, 1))))
    bw = BitWriter()
    head(bw)
    while bw.nbits:
        bw.u(1 if bw.nbits == 8 else 0, 1)  # nesting alignment quirk
    bw2 = BitWriter()
    bw2.u(inner.payload_type, 8)
    bw2.u(len(inner.payload), 8)
    bw2.write_bytes(inner.payload)
    return bw.get_bytes() + bw2.get_bytes()


def test_scalable_nesting_recurses():
    out = sei.parse_scalable_nesting(_nesting(
        lambda b: (b.u(0, 1), b.u(0, 1), b.u(1, 1))))
    assert out["nested"] and out["nested"][0].payload_type == 6
    assert sei.parse_structured(out["nested"][0])["exact_match_flag"] == 1


def test_scalable_nesting_default_op_flag():
    # spec D.2.27: with default_op_flag=1 the op loop starts at i=1, so
    # nesting_num_ops_minus1=1 codes exactly ONE (u(3), ue) op pair.
    out = sei.parse_scalable_nesting(_nesting(lambda b: (
        b.u(1, 1), b.u(1, 1), b.u(1, 1), b.ue(1), b.u(3, 3), b.ue(5))))
    assert out["default_op_flag"] == 1
    assert len(out["ops"]) == 1
    assert out["ops"][0]["nesting_max_temporal_id_plus1"] == 3
    assert out["ops"][0]["nesting_op_idx"] == 5
    assert out["nested"] and out["nested"][0].payload_type == 6


def test_unknown_and_extension_types_are_skip_safe():
    for t in (139, 142, 165, 177, 250):
        r = sei.parse_structured(sei.SeiMessage(t, b"\x12\x34"))
        assert r is None or isinstance(r, dict)


def test_structured_never_raises_on_truncation():
    for t in sei._STRUCTURED_PARSERS:
        for payload in (b"", b"\x01", b"\xff\x00", b"\x80" * 3):
            r = sei.parse_structured(sei.SeiMessage(t, payload))
            assert r is None or isinstance(r, dict)
            assert _plain(r) == _plain(jsei.parse_structured(
                jsei.SeiMessage(t, payload)))


def test_stream_sei_messages_parse_as_in_jax():
    """Every SEI message of vfy_fullsei.hevc (the encoder's full prefix
    set and the hash suffixes) parses to the JAX package's values."""
    types = set()
    for nal in iter_nal_units(_data("vfy_fullsei.hevc")):
        if nal.nal_unit_type not in (T.NalUnitType.PREFIX_SEI_NUT,
                                     T.NalUnitType.SUFFIX_SEI_NUT):
            continue
        got = sei.parse_sei_rbsp(nal.rbsp)
        want = jsei.parse_sei_rbsp(nal.rbsp)
        assert [(m.payload_type, m.payload) for m in got] == [
            (m.payload_type, m.payload) for m in want]
        for m, j in zip(got, want):
            types.add(m.payload_type)
            assert _plain(sei.parse_structured(m)) == _plain(
                jsei.parse_structured(j))
    assert len(types) >= 4, types


# -- tests/test_headers.py ---------------------------------------------

def _parse(mod_hs, mod_params, reader, data):
    """(ParamSets, [(slice header, header end bit, rbsp)], {"sps": rbsp,
    "pps": rbsp}) of a stream with one package's parsers."""
    ps = mod_params.ParamSets()
    slices, payloads = [], {}
    for nal in reader.iter_nal_units(data):
        br = reader.BitReader(nal.rbsp)
        t = nal.nal_unit_type
        if t == T.NalUnitType.VPS_NUT:
            v = mod_hs.parse_vps(br)
            ps.vps[v.vps_video_parameter_set_id] = v
        elif t == T.NalUnitType.SPS_NUT:
            s = mod_hs.parse_sps(br)
            ps.sps[s.sps_seq_parameter_set_id] = s
            payloads["sps"] = nal.rbsp
        elif t == T.NalUnitType.PPS_NUT:
            p = mod_hs.parse_pps(br)
            ps.pps[p.pps_pic_parameter_set_id] = p
            payloads["pps"] = nal.rbsp
        elif T.is_vcl(t):
            sh = mod_hs.parse_slice_segment_header(br, t, nal.temporal_id,
                                                   ps)
            slices.append((sh, br.pos, nal.rbsp))
    return ps, slices, payloads


@pytest.fixture(scope="module", params=["vfy_fullsei.hevc", "ms_dep4.hevc"])
def parsed(request):
    import turingcodec_tpu_torch.bitstream.reader as treader
    data = _data(request.param)
    return (request.param, _parse(hs, params, treader, data),
            _parse(jhs, jparams, jreader, data))


def test_headers_parse_as_in_jax(parsed):
    _name, (ps, slices, _), (jps, jslices, _) = parsed
    for kind in ("vps", "sps", "pps"):
        assert _plain(getattr(ps, kind)) == _plain(getattr(jps, kind))
    assert len(slices) == len(jslices) > 0
    for (sh, pos, _), (jsh, jpos, _) in zip(slices, jslices):
        assert pos == jpos and _plain(sh) == _plain(jsh)


def test_slice_header_reserialize(parsed):
    """Every slice header re-serialises bit-exactly."""
    name, (ps, slices, _), _ = parsed
    dependent = 0
    for sh, end_pos, rbsp in slices:
        sps, pps = ps.activate(sh.slice_pic_parameter_set_id)
        bw = BitWriter()
        hs.write_slice_segment_header(bw, sh, sps, pps)
        assert end_pos % 8 == 0
        assert bw.get_bytes() == rbsp[:end_pos // 8], (
            f"{name}: slice header mismatch at poc "
            f"{sh.slice_pic_order_cnt_lsb}")
        dependent += sh.dependent_slice_segment_flag
    assert (dependent > 0) == (name == "ms_dep4.hevc")


def test_sps_pps_reserialize(parsed):
    """The SPS and PPS writers reproduce the parsed stream bit-exactly."""
    _name, (ps, _, payloads), _ = parsed
    bw = BitWriter()
    hs.write_sps(bw, ps.sps[0])
    assert bw.get_bytes() == payloads["sps"]
    bw = BitWriter()
    hs.write_pps(bw, ps.pps[0])
    assert bw.get_bytes() == payloads["pps"]


def test_level_derivation():
    """general_level_idc from the A.4 levels table (Encoder.cpp:590-606):
    smallest Main-tier level fitting picture size and luma sample rate."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    from turingcodec_tpu_torch.hevc.tables import derive_level
    assert derive_level(352 * 288, 30.0)[0] == 60       # CIF30 -> 2.0
    assert derive_level(640 * 360, 24.0)[0] == 63       # 360p24 -> 2.1
    assert derive_level(1920 * 1080, 24.0)[0] == 120    # 1080p24 -> 4.0
    assert derive_level(1920 * 1080, 60.0)[0] == 123    # 1080p60 -> 4.1
    assert derive_level(3840 * 2160, 60.0)[0] == 153    # 2160p60 -> 5.1
    enc = Encoder(EncoderConfig(width=640, height=360, qp=30,
                                frame_rate=24.0, device=None))
    assert enc.sps.ptl.general_level_idc == 63
