"""GOP/SOP planning: encode-order scheduling with hierarchical-B structure.

The InputQueue analogue (turing/InputQueue.cpp:331-379 hard-codes SOP tables
for gop sizes 2..8); here the standard random-access mini-GOP structures are
expressed as data. Each entry: (poc_offset within SOP, temporal_id,
qp_offset, refs as poc offsets relative to SOP base).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# (poc_off, tid, qp_off, refs_before, refs_after, qp_factor) — encode
# order; qp offsets and lambda qpFactors mirror the reference's SOP tables
# (InputQueue.cpp:331-379: anchors 0.4420, mid levels 0.3536, leaves 0.6800)
_SOP_TABLES = {
    1: [(1, 0, 1, [1], [], 0.4420)],
    2: [(2, 0, 1, [2], [], 0.4420),
        (1, 1, 2, [1], [1], 0.6800)],
    3: [(3, 0, 1, [3], [], 0.4420),
        (2, 1, 2, [2], [1], 0.3536),
        (1, 2, 3, [1], [1, 2], 0.6800)],
    4: [(4, 0, 1, [4], [], 0.4420),
        (2, 1, 2, [2], [2], 0.3536),
        (1, 2, 3, [1], [1, 3], 0.6800),
        (3, 2, 3, [1, 3], [1], 0.6800)],
    5: [(5, 0, 1, [5], [], 0.4420),
        (3, 1, 2, [3], [2], 0.3536),
        (1, 1, 2, [1], [2, 4], 0.3536),
        (2, 2, 3, [1, 2], [1, 3], 0.6800),
        (4, 2, 3, [1, 4], [1], 0.6800)],
    6: [(6, 0, 1, [6], [], 0.4420),
        (3, 1, 2, [3], [3], 0.3536),
        (1, 2, 3, [1], [2, 5], 0.3536),
        (2, 3, 4, [1, 2], [1, 4], 0.6800),
        (5, 2, 3, [2, 5], [1], 0.3536),
        (4, 3, 4, [1, 4], [1, 2], 0.6800)],
    7: [(7, 0, 1, [7], [], 0.4420),
        (4, 1, 2, [4], [3], 0.3536),
        (2, 2, 3, [2], [2, 5], 0.3536),
        (1, 3, 4, [1], [1, 3, 6], 0.6800),
        (3, 3, 4, [1, 3], [1, 4], 0.6800),
        (6, 2, 3, [2], [1], 0.3536),
        (5, 3, 4, [1], [1, 2], 0.6800)],
    8: [(8, 0, 1, [8], [], 0.4420),
        (4, 1, 2, [4], [4], 0.3536),
        (2, 2, 3, [2], [2, 6], 0.3536),
        (1, 3, 4, [1], [1, 3, 7], 0.6800),
        (3, 3, 4, [1, 3], [1, 5], 0.6800),
        (6, 2, 3, [2, 6], [2], 0.3536),
        (5, 3, 4, [1, 5], [1, 3], 0.6800),
        (7, 3, 4, [1, 7], [1], 0.6800)],
}


@dataclass
class Docket:
    """One picture's encode order entry (InputQueue.h:61-83 analogue)."""
    input_index: int
    poc: int
    is_idr: bool
    slice_type: int          # 0 B, 1 P, 2 I
    temporal_id: int = 0
    qp_offset: int = 0
    qp_factor: float = 0.4420  # lambda factor (InputQueue qpFactor)
    refs_before: List[int] = field(default_factory=list)  # POCs
    refs_after: List[int] = field(default_factory=list)
    retain: List[int] = field(default_factory=list)  # POCs future pics need


class GopPlanner:
    """Buffers input frames, emits dockets in encode order."""

    def __init__(self, gop_m: int = 8, intra_period: int = 0,
                 low_delay: bool = False):
        assert gop_m in _SOP_TABLES, gop_m
        self.m = 1 if low_delay else gop_m
        self.low_delay = low_delay or gop_m == 1
        self.intra_period = intra_period
        self.pending: List[int] = []   # input indices not yet scheduled
        self.n_in = 0
        self.base_poc = 0              # POC of the last scheduled SOP end
        self.idr_input = 0             # input index of the current IDR
        self._held_idr = None          # IDR delayed one input (RA only)

    def push(self, force_idr: bool = False) -> List[Docket]:
        """Register one more input frame; returns any newly-ready dockets.

        force_idr: shot-change hook (InputQueue computeNextIdr analogue) —
        pending frames are emitted as partial SOPs first.
        """
        idx = self.n_in
        self.n_in += 1
        out = []
        if self._held_idr is not None:
            # release the 1-input-delayed IDR (RA lookahead slot) before
            # anything that follows it
            out.append(Docket(input_index=self._held_idr, poc=0,
                              is_idr=True, slice_type=2))
            self._held_idr = None
        if self._is_idr_input(idx) or force_idr:
            out.extend(self._drain_sops())
            self.idr_input = idx
            self.base_poc = 0
            self.pending = []
            if self.m > 1:
                # hierarchical GOPs already reorder: hold the IDR one
                # input so its pre-analysis can consult the next source
                # picture (temporal-unpredictability lambda rule)
                self._held_idr = idx
                return out
            out.append(Docket(input_index=idx, poc=0, is_idr=True,
                              slice_type=2))
            return out
        self.pending.append(idx)
        if len(self.pending) == self.m:
            out.extend(self._emit_sop())
        return out

    def flush(self) -> List[Docket]:
        """Emit dockets for a held IDR and a final partial SOP
        (low-delay order)."""
        out = []
        if self._held_idr is not None:
            out.append(Docket(input_index=self._held_idr, poc=0,
                              is_idr=True, slice_type=2))
            self._held_idr = None
        out.extend(self._drain_sops())
        return out

    def _drain_sops(self) -> List[Docket]:
        out = []
        while self.pending:
            # encode remaining frames as one exact-size SOP (the
            # reference has dedicated tables for every size 1..8,
            # InputQueue.cpp:331-379)
            out.extend(self._emit_sop(min(len(self.pending), 8)))
        return out

    def _is_idr_input(self, idx: int) -> bool:
        if idx == 0:
            return True
        if self.intra_period:
            return (idx - self.idr_input) % self.intra_period == 0 and \
                idx != self.idr_input
        return False

    def _emit_sop(self, m: Optional[int] = None) -> List[Docket]:
        m = m or self.m
        table = _SOP_TABLES[m]
        base = self.base_poc
        batch = self.pending[:m]
        self.pending = self.pending[m:]
        out = []
        for (off, tid, qp_off, rb, ra, qp_factor) in table:
            poc = base + off
            # always B: low delay codes generalized P-B (GPB) slices with
            # L0 == L1 == {previous}, like the reference (InputQueue.cpp:327
            # lastPicture=='P' dockets become TRAIL_R B slices; bi-prediction
            # of two same-list MC blocks acts as a denoising 2-tap filter)
            slice_type = 0
            if not self.low_delay:
                refs_before = [poc - d for d in rb if poc - d >= 0]
                refs_after = [poc + d for d in ra if base + m >= poc + d]
            else:
                refs_before = [poc - 1]
                refs_after = []
            out.append(Docket(
                input_index=batch[off - 1], poc=poc, is_idr=False,
                slice_type=slice_type, temporal_id=tid, qp_offset=qp_off,
                qp_factor=qp_factor,
                refs_before=sorted(set(refs_before), reverse=True),
                refs_after=sorted(set(refs_after))))
        # retention: each docket keeps what later dockets (and the next SOP
        # anchor, which references base+m) still need
        for k, d in enumerate(out):
            need = {base + m}
            for later in out[k + 1:]:
                need.update(later.refs_before)
                need.update(later.refs_after)
            need.discard(d.poc)
            d.retain = sorted(need)
        self.base_poc = base + m
        return out
