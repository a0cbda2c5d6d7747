"""Bitstream reading: Annex-B NAL extraction, emulation-prevention removal,
and an MSB-first bit reader with the HEVC descriptors u(n)/ue(v)/se(v).

Parity reference: turing/StreamReader.h:56 (NAL access), turing/Read.h:300-418
(fixed/ue/se readers), turing/SyntaxNal.hpp (byte_stream_nal_unit / EP3).

Design: unlike the reference's incremental streaming reader, we scan the whole
buffer up front with numpy (vectorized start-code and 00 00 03 search) — the
host-side analogue of doing work in large batches rather than byte loops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


def find_start_codes(data: bytes) -> np.ndarray:
    """Return positions i such that data[i:i+3] == 00 00 01 (vectorized)."""
    a = np.frombuffer(data, dtype=np.uint8)
    if a.size < 3:
        return np.empty(0, dtype=np.int64)
    hit = (a[:-2] == 0) & (a[1:-1] == 0) & (a[2:] == 1)
    return np.nonzero(hit)[0]


def split_nal_units(data: bytes) -> List[Tuple[int, int]]:
    """Split an Annex-B byte stream into (start, end) spans of NAL payloads
    (span excludes the start code; includes header + EBSP payload).

    Zero bytes immediately preceding the next 00 00 01 are stripped: they are
    either the leading zero of a 4-byte start code or trailing_zero_8bits —
    valid EBSP payloads never end in 0x00 (rbsp_trailing_bits / cabac_zero_
    words both end non-zero).
    """
    starts = find_start_codes(data)
    spans: List[Tuple[int, int]] = []
    for k, s in enumerate(starts):
        payload_start = int(s) + 3
        end = int(starts[k + 1]) if k + 1 < len(starts) else len(data)
        while end > payload_start and data[end - 1] == 0:
            end -= 1
        spans.append((payload_start, end))
    return spans


def remove_emulation_prevention(ebsp: bytes) -> bytes:
    """EBSP -> RBSP: remove each 0x03 that follows 00 00 (vectorized)."""
    a = np.frombuffer(ebsp, dtype=np.uint8)
    if a.size < 3:
        return ebsp
    is3 = np.zeros(a.size, dtype=bool)
    cand = (a[2:] == 3) & (a[1:-1] == 0) & (a[:-2] == 0)
    idx = np.nonzero(cand)[0] + 2
    # consecutive escapes: 00 00 03 00 00 03 — after removing a 03 the
    # preceding zero pair can't chain through the removed byte, but two
    # candidates can't overlap anyway (03 breaks the zero run), so a single
    # vectorized pass is exact.
    is3[idx] = True
    return a[~is3].tobytes()


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """RBSP -> EBSP: insert 0x03 after any 00 00 followed by 00/01/02/03."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


@dataclass
class NalUnit:
    nal_unit_type: int
    nuh_layer_id: int
    temporal_id: int  # nuh_temporal_id_plus1 - 1
    rbsp: bytes       # payload after the 2-byte header, EP3 removed

    @property
    def type_name(self) -> str:
        from turingcodec_tpu_torch.hevc.types import NalUnitType
        try:
            return NalUnitType(self.nal_unit_type).name
        except ValueError:
            return f"NUT_{self.nal_unit_type}"


def parse_nal_header(b0: int, b1: int) -> Tuple[int, int, int]:
    """nal_unit_header(): forbidden(1) type(6) layer(6) tid_plus1(3)."""
    nal_unit_type = (b0 >> 1) & 0x3F
    nuh_layer_id = ((b0 & 1) << 5) | (b1 >> 3)
    temporal_id = (b1 & 7) - 1
    return nal_unit_type, nuh_layer_id, temporal_id


def iter_nal_units(data: bytes) -> Iterator[NalUnit]:
    for s, e in split_nal_units(data):
        if e - s < 2:
            continue
        nut, layer, tid = parse_nal_header(data[s], data[s + 1])
        rbsp = remove_emulation_prevention(data[s + 2:e])
        yield NalUnit(nut, layer, tid, rbsp)


class BitReader:
    """MSB-first bit reader over an RBSP buffer.

    Keeps position as a single bit index; reads assemble from the underlying
    bytes. ue(v) uses leading-zero count per spec 9.2.
    """

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = 8 * len(data)

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def u(self, n: int) -> int:
        """Read n bits unsigned, MSB first."""
        if n == 0:
            return 0
        pos = self.pos
        end = pos + n
        if end > self.nbits:
            raise EOFError("bitstream overrun")
        first_byte = pos >> 3
        last_byte = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first_byte:last_byte], "big")
        total_bits = (last_byte - first_byte) * 8
        shift = total_bits - (pos - first_byte * 8) - n
        self.pos = end
        return (chunk >> shift) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        save = self.pos
        try:
            return self.u(n)
        finally:
            self.pos = save

    def f(self, n: int) -> int:
        return self.u(n)

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        """Exp-Golomb unsigned (spec 9.2)."""
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 40:
                raise ValueError("invalid exp-golomb code")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """Exp-Golomb signed (spec 9.2.2): k -> (-1)^(k+1) * ceil(k/2)."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def more_rbsp_data(self) -> bool:
        """Spec 7.2: true if there is data before rbsp_stop_one_bit."""
        if self.bits_left() <= 0:
            return False
        # find last byte with any set bit
        data = self.data
        last = len(data) - 1
        while last >= 0 and data[last] == 0:
            last -= 1
        if last < 0:
            return False
        b = data[last]
        # position of rbsp_stop_one_bit: last set bit in that byte
        stop_bit = 8 * last + 7 - ((b & -b).bit_length() - 1)
        return self.pos < stop_bit

    def rbsp_trailing_bits(self):
        from turingcodec_tpu_torch.decode.violations import Violation
        if self.u(1) != 1:
            raise Violation("7.3.2.11", "rbsp_stop_one_bit must be 1")
        while not self.byte_aligned():
            if self.u(1) != 0:
                raise Violation("7.3.2.11",
                                "rbsp_alignment_zero_bit must be 0")

    def byte_alignment(self):
        from turingcodec_tpu_torch.decode.violations import Violation
        if self.u(1) != 1:
            raise Violation("7.3.2.12", "alignment_bit_equal_to_one")
        while not self.byte_aligned():
            if self.u(1) != 0:
                raise Violation("7.3.2.12",
                                "alignment_zero_bit must be 0")

    def remaining_bytes(self) -> bytes:
        assert self.byte_aligned()
        return self.data[self.pos >> 3:]
