"""CABAC arithmetic engines (ITU-T H.265 clause 9.3.4).

Host-side sequential engines: CABAC bin coding is inherently serial (each bin
update feeds the next), so it runs on the host while all pixel work is batched
on TPU. The context pool is a flat numpy uint8 array (packed 2*pStateIdx+mps)
so a whole pool snapshot/restore (needed for WPP row inheritance and RDO
estimate-vs-write checks) is a single array copy.

Parity reference: decoder turing/Read.h:462-676; encoder turing/CabacWriter.h:
100-190; context pool turing/Cabac.h:411-436.
"""
from __future__ import annotations

import numpy as np

from .tables import (
    CONTEXT_OFFSET,
    INIT_TABLE,
    NEXT_STATE_LPS,
    NEXT_STATE_MPS,
    NUM_CONTEXTS,
    RANGE_TAB_LPS,
)

# Python-list copies are faster than numpy scalar indexing in the bin loop.
_RANGE_LPS = [tuple(int(x) for x in row) for row in RANGE_TAB_LPS]
_NEXT_MPS = [int(x) for x in NEXT_STATE_MPS]
_NEXT_LPS = [int(x) for x in NEXT_STATE_LPS]


class ContextPool:
    """Flat pool of packed context states, indexed by element name + ctxInc."""

    __slots__ = ("states",)

    def __init__(self, states=None):
        if states is None:
            states = bytearray(NUM_CONTEXTS)
        self.states = states

    def initialize(self, init_type: int, slice_qp_y: int):
        qp = min(max(slice_qp_y, 0), 51)
        self.states = bytearray(
            np.asarray(INIT_TABLE[init_type, qp], np.uint8).tobytes())

    def copy(self) -> "ContextPool":
        return ContextPool(bytearray(self.states))

    def __eq__(self, other):
        return self.states == other.states


def ctx_index(element: str, inc: int = 0) -> int:
    return CONTEXT_OFFSET[element] + inc


class CabacDecoder:
    """Arithmetic decoding engine (spec 9.3.4.3).

    Reads bits MSB-first from ``data`` starting at bit position ``pos``.
    """

    __slots__ = ("data", "pos", "nbits", "range", "offset", "ctx",
                 "_cache", "_cache_bits")

    def __init__(self, data: bytes, pos_bits: int, ctx: ContextPool):
        self.data = data
        self.pos = pos_bits
        self.nbits = 8 * len(data)
        self.ctx = ctx
        # bit cache: up to 8 bytes prefetched; `pos` stays the semantic bit
        # position (cache refills adjust nothing visible)
        self._cache = 0
        self._cache_bits = 0
        self.range = 510
        self.offset = self._read_bits(9)

    def _read_bits(self, n: int) -> int:
        cb = self._cache_bits
        cache = self._cache
        if cb < n:
            # refill up to 8 bytes starting at bit position pos + cb
            start_bit = self.pos + cb
            chunk = self.data[start_bit >> 3:(start_bit >> 3) + 8]
            got = len(chunk) * 8 - (start_bit & 7)
            if got > 0:
                cache = (cache << got) | (
                    int.from_bytes(chunk, "big") & ((1 << got) - 1))
                cb += got
            if cb < n:
                # past-the-end bits read as 0 (decoder robustness)
                cache <<= n - cb
                cb = n
        out = (cache >> (cb - n)) & ((1 << n) - 1)
        cb -= n
        self._cache = cache & ((1 << cb) - 1)
        self._cache_bits = cb
        self.pos += n
        return out

    def restart(self):
        """Re-init arithmetic state at current (byte-aligned) position —
        used after pcm alignment and at dependent-slice boundaries."""
        self.range = 510
        self.offset = self._read_bits(9)

    def decode_decision(self, ctx_idx: int) -> int:
        states = self.ctx.states
        s = states[ctx_idx]
        r = self.range
        lps = _RANGE_LPS[s >> 1][(r >> 6) & 3]
        r -= lps
        off = self.offset
        if off >= r:
            bin_val = 1 - (s & 1)
            off -= r
            r = lps
            states[ctx_idx] = _NEXT_LPS[s]
        else:
            bin_val = s & 1
            states[ctx_idx] = _NEXT_MPS[s]
        # renormalize: smallest n with r << n >= 256 (r in [2, 255])
        if r < 256:
            n = 9 - r.bit_length()
            r <<= n
            off = (off << n) | self._read_bits(n)
        self.range = r
        self.offset = off
        return bin_val

    def decode_bypass(self) -> int:
        off = (self.offset << 1) | self._read_bits(1)
        r = self.range
        if off >= r:
            off -= r
            bin_val = 1
        else:
            bin_val = 0
        self.offset = off
        return bin_val

    def decode_bypass_bits(self, n: int) -> int:
        """n consecutive bypass bins as an unsigned integer."""
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        r = self.range - 2
        if self.offset >= r:
            # end of slice / pcm escape: range is not renormalized
            self.range = r
            return 1
        if r < 256:
            n = 9 - r.bit_length()
            r <<= n
            self.offset = (self.offset << n) | self._read_bits(n)
        self.range = r
        return 0

    # --- standard binarizations -------------------------------------------
    def decode_tr_bypass(self, c_max: int) -> int:
        """Truncated-rice with rice param 0 done in bypass (not used often)."""
        v = 0
        while v < c_max and self.decode_bypass():
            v += 1
        return v

    def decode_egk_bypass(self, k: int) -> int:
        """k-th order Exp-Golomb, bypass bins (spec 9.3.3.3)."""
        value = 0
        while self.decode_bypass():
            value += 1 << k
            k += 1
        if k:
            value += self.decode_bypass_bits(k)
        return value

    def byte_align_position(self) -> int:
        """Byte position after CABAC content: offset holds the last-read bits.

        After decode_terminate()==1 the spec consumes bits so that the
        position is at the next byte boundary minus the held bits; for
        end_of_sub_stream handling we just round the raw position up.
        """
        return (self.pos + 7) >> 3


class CabacEncoder:
    """Arithmetic encoding engine (spec 9.3.4.4, PutBit/bitsOutstanding form).

    Emits bits into a caller-provided BitWriter. The first emitted bit is
    discarded per spec (firstBitFlag).
    """

    __slots__ = ("bw", "low", "range", "bits_outstanding", "first_bit", "ctx",
                 "bin_count")

    def __init__(self, bit_writer, ctx: ContextPool):
        self.bw = bit_writer
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self.bin_count = 0

    def _put_bit(self, b: int):
        if self.first_bit:
            self.first_bit = False
        else:
            self.bw.u(b, 1)
        while self.bits_outstanding > 0:
            self.bw.u(1 - b, 1)
            self.bits_outstanding -= 1

    def _renorm(self):
        low = self.low
        r = self.range
        while r < 256:
            if low >= 0x200:
                self._put_bit(1)
                low -= 0x200
            elif low < 0x100:
                self._put_bit(0)
            else:
                low -= 0x100
                self.bits_outstanding += 1
            r <<= 1
            low <<= 1
        self.low = low
        self.range = r

    def encode_decision(self, ctx_idx: int, bin_val: int):
        self.bin_count += 1
        states = self.ctx.states
        s = states[ctx_idx]
        lps = _RANGE_LPS[s >> 1][(self.range >> 6) & 3]
        self.range -= lps
        if bin_val != (s & 1):
            self.low += self.range
            self.range = lps
            states[ctx_idx] = _NEXT_LPS[s]
        else:
            states[ctx_idx] = _NEXT_MPS[s]
        if self.range < 256:
            self._renorm()

    def encode_bypass(self, bin_val: int):
        self.bin_count += 1
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 0x400:
            self._put_bit(1)
            self.low -= 0x400
        elif self.low < 0x200:
            self._put_bit(0)
        else:
            self.low -= 0x200
            self.bits_outstanding += 1

    def encode_bypass_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bin_val: int):
        self.bin_count += 1
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put_bit((self.low >> 9) & 1)
            # final 2 bits: ((low >> 7) & 3) | 1  (rbsp_stop_one_bit folded in)
            self.bw.u(((self.low >> 7) & 3) | 1, 2)
        else:
            self._renorm()

    def encode_egk_bypass(self, value: int, k: int):
        while value >= (1 << k):
            self.encode_bypass(1)
            value -= 1 << k
            k += 1
        self.encode_bypass(0)
        if k:
            self.encode_bypass_bits(value, k)
