"""Conformance violation machinery (turing/Violation.h:41-72,
RangeLimits.h:29-40 analogue): clause-tagged errors on malformed streams,
with fatal vs recoverable classification.
"""
from __future__ import annotations


class Violation(Exception):
    """A bitstream conformance violation, tagged with the spec clause."""

    def __init__(self, clause: str, message: str):
        self.clause = clause
        super().__init__(f"[{clause}] {message}")


class Abort(Violation):
    """A violation from which decoding of the stream cannot continue."""


def check_range(clause: str, name: str, value, lo, hi):
    if not (lo <= value <= hi):
        raise Violation(clause,
                        f"{name} = {value} outside [{lo}, {hi}]")
    return value
