"""CLI: the decoder's robustness to bit flips on an in-repo stream (the
turing/RangeLimits.h + Violation.h analogue; tests/test_malformed.py's
sweep moved from the absent caminandes clip onto
tests/streams/vfy_sweep.hevc).

Each case flips one bit of the stream and decodes its first MAX_FRAMES
frames. It must end in a clause-tagged Violation or a decode, never
another exception; a decode may record and skip NAL units it cannot
parse (the Violation.h robustness semantics, as the JAX decoder does:
a slice whose parameter set was skipped is recorded with its KeyError,
untagged, in both packages). A native crash kills the process, so
callers run the sweep in a child process and resume after the case it
died on (tests/test_torch_malformed.py).

Usage: python -m turingcodec_tpu_torch.tools.bitflip
           [--device {cuda,none,cpu}] [--positions {header,slice}]
           [--start POS]

Prints "AT pos bit" before each case, "RAW pos bit ..." for an exception
other than a Violation, "UNTAGGED pos bit ..." for a Violation without a
spec clause, "DONE" at the end. --device cuda (the default) decodes on
the GPU and raises without one; none is the host path; cpu runs the
device pipeline through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

STREAM = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "streams", "vfy_sweep.hevc")
# the parameter sets and the IDR's slice header (bytes 1-90), and slice
# data across every picture of the 20290-byte stream
POSITIONS = {"header": range(6, 100, 6), "slice": range(400, 20000, 1960)}
BITS = (0x01, 0x40)
MAX_FRAMES = 2


def flipped(data: bytes, pos: int, bit: int) -> bytes:
    mut = bytearray(data)
    mut[pos] ^= bit
    return bytes(mut)


def tagged(clause) -> bool:
    return bool(clause) and clause[0].isdigit()


def outcome(data: bytes, device=None, max_frames: int = MAX_FRAMES):
    """("violation", clause, message) when the decode raises a Violation;
    else ("decoded", planes of each frame, hash failures, the violations
    recorded for skipped NAL units)."""
    from turingcodec_tpu_torch.decode.decoder import Decoder
    from turingcodec_tpu_torch.decode.violations import Violation
    try:
        dec = Decoder(device=device)
        planes = [[np.asarray(p).copy() for p in f.planes]
                  for f in dec.decode_stream(data, max_frames=max_frames)]
    except Violation as v:
        return ("violation", v.clause, str(v))
    return ("decoded", planes, dec.hash_failures, list(dec.violations))


def same(a, b) -> bool:
    """Two outcomes agree: the same Violation clause, or the same planes,
    hash failures and recorded violations."""
    if a[0] != b[0]:
        return False
    if a[0] == "violation":
        return a[1] == b[1]
    return (len(a[1]) == len(b[1]) and a[2:] == b[2:]
            and all(np.array_equal(x, y) for fa, fb in zip(a[1], b[1])
                    for x, y in zip(fa, fb)))


def sweep(data: bytes, positions, device=None, start: int = 0,
          log=print) -> int:
    """Every flip at `positions` >= start and each of BITS; returns the
    number of cases that ended in neither a tagged Violation nor a decode
    (each logged as RAW or UNTAGGED)."""
    bad = 0
    for pos in positions:
        if pos < start:
            continue
        for bit in BITS:
            log(f"AT {pos} {bit}")
            try:
                got = outcome(flipped(data, pos, bit), device)
            except Exception as e:
                bad += 1
                log(f"RAW {pos} {bit} {type(e).__name__} {str(e)[:80]}")
                continue
            if got[0] == "violation" and not tagged(got[1]):
                bad += 1
                log(f"UNTAGGED {pos} {bit} {got[2][:80]}")
    log("DONE")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turingcodec_tpu_torch bitflip")
    ap.add_argument("--device", choices=["cuda", "none", "cpu"],
                    default="cuda")
    ap.add_argument("--positions", choices=sorted(POSITIONS),
                    default="header")
    ap.add_argument("--start", type=int, default=0,
                    help="skip the positions below this one")
    args = ap.parse_args(argv)
    device = None if args.device == "none" else args.device
    if device is not None:
        from turingcodec_tpu_torch.encode.device_analysis import (
            resolve_device)
        resolve_device(device)   # raises without a usable card
    with open(STREAM, "rb") as f:
        data = f.read()
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    return 1 if sweep(data, POSITIONS[args.positions], device, args.start,
                      log) else 0


if __name__ == "__main__":
    sys.exit(main())
