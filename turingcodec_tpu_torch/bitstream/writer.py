"""Bitstream writing: MSB-first bit writer with ue/se, NAL assembly with
emulation prevention, Annex-B start codes.

Parity reference: turing/CabacWriter.h:72-90 (BitWriter + insertEp3Bytes),
turing/Write.h:99-123 (header writing).
"""
from __future__ import annotations

from .reader import insert_emulation_prevention


class BitWriter:
    """Accumulates bits MSB-first into a bytearray."""

    __slots__ = ("buf", "cur", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.cur = 0     # bits accumulated in the partial byte (MSB side)
        self.nbits = 0   # number of valid bits in cur (0..7)

    def u(self, value: int, n: int):
        if n == 0:
            return
        assert 0 <= value < (1 << n), (value, n)
        cur = (self.cur << n) | value
        nbits = self.nbits + n
        while nbits >= 8:
            nbits -= 8
            self.buf.append((cur >> nbits) & 0xFF)
        self.cur = cur & ((1 << nbits) - 1)
        self.nbits = nbits

    def flag(self, b) -> None:
        self.u(1 if b else 0, 1)

    def ue(self, value: int):
        assert value >= 0
        v = value + 1
        nbits = v.bit_length()
        self.u(0, nbits - 1)
        self.u(v, nbits)

    def se(self, value: int):
        # spec 9.2.2 inverse: positive v -> 2v-1, non-positive v -> -2v
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def bit_position(self) -> int:
        return len(self.buf) * 8 + self.nbits

    def byte_aligned(self) -> bool:
        return self.nbits == 0

    def rbsp_trailing_bits(self):
        self.u(1, 1)
        if self.nbits:
            self.u(0, 8 - self.nbits)

    def byte_alignment(self):
        self.rbsp_trailing_bits()  # identical bit pattern

    def write_bytes(self, data: bytes):
        assert self.byte_aligned()
        self.buf.extend(data)

    def get_bytes(self) -> bytes:
        assert self.byte_aligned(), "unterminated RBSP"
        return bytes(self.buf)


def wrap_nal(nal_unit_type: int, rbsp: bytes, temporal_id: int = 0,
             layer_id: int = 0, long_start_code: bool = True) -> bytes:
    """Build an Annex-B NAL unit: start code + 2-byte header + EBSP."""
    b0 = (nal_unit_type << 1) | (layer_id >> 5)
    b1 = ((layer_id & 0x1F) << 3) | (temporal_id + 1)
    ebsp = insert_emulation_prevention(rbsp)
    sc = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return sc + bytes([b0, b1]) + ebsp
