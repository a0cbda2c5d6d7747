"""Plain reading of an HEVC Annex-B stream's decoded-picture-hash SEI.

Written for the benchmark from the H.265 text (Annex B byte stream, 7.3.1
NAL unit header, 7.3.2.4 emulation prevention, 7.3.5 SEI message, D.2.20
decoded picture hash); it imports nothing of the port. MD5 of a picture
component is the MD5 of its samples in raster order, one byte each at 8
bits, two little-endian bytes each above 8 (D.3.19).
"""
from __future__ import annotations

import hashlib

import numpy as np

PREFIX_SEI, SUFFIX_SEI = 39, 40
DECODED_PICTURE_HASH = 132


def nal_units(data: bytes):
    """The NAL units of an Annex-B byte stream, start codes removed."""
    starts = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i + 3)
        i = data.find(b"\x00\x00\x01", i + 3)
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else len(data)
        nal = data[s:end]
        # a trailing zero belongs to the next 4-byte start code
        while nal.endswith(b"\x00"):
            nal = nal[:-1]
        if nal:
            yield nal


def rbsp(nal: bytes) -> bytes:
    """The payload after the 2-byte NAL header, emulation prevention
    bytes (00 00 03) removed."""
    out = bytearray()
    zeros = 0
    for b in nal[2:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


def picture_md5s(data: bytes) -> list:
    """Every MD5 decoded-picture-hash SEI of the stream in order, each a
    list of one 16-byte digest per colour component."""
    out = []
    for nal in nal_units(data):
        if nal_type(nal) not in (PREFIX_SEI, SUFFIX_SEI):
            continue
        r = rbsp(nal)
        i = 0
        while i < len(r) and r[i:] != b"\x80":
            ptype = 0
            while r[i] == 0xFF:
                ptype += 255
                i += 1
            ptype += r[i]
            i += 1
            size = 0
            while r[i] == 0xFF:
                size += 255
                i += 1
            size += r[i]
            i += 1
            payload = r[i:i + size]
            i += size
            if ptype == DECODED_PICTURE_HASH:
                if payload[0] != 0:
                    raise ValueError(f"hash type {payload[0]}, not MD5")
                n = (len(payload) - 1) // 16
                out.append([bytes(payload[1 + 16 * c:17 + 16 * c])
                            for c in range(n)])
    return out


def planes_md5(planes, bit_depth: int = 8) -> list:
    """The D.3.19 MD5 of each component plane."""
    dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    return [hashlib.md5(np.ascontiguousarray(p).astype(dt).tobytes())
            .digest() for p in planes]
