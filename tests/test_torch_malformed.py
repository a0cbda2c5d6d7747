"""The port's decoder robustness (tests/test_malformed.py's bit-flip
sweep, moved from the absent caminandes clip onto
tests/streams/vfy_sweep.hevc by turingcodec_tpu_torch/tools/bitflip.py):
every flipped stream ends in a clause-tagged Violation or a clean decode,
never a raw exception or a native crash, on the host path (device=None)
and through the device pipeline's plain versions (device="cpu"). The
sweep runs in a child process so a native abort is reported as a failure
instead of killing the test run; the host path's outcomes are the JAX
decoder's. The "cpu" sweeps are in tests/test_torch_malformed_pipeline.py.
"""
import subprocess
import sys

import pytest

from turingcodec_tpu_torch.tools import bitflip

REPO = bitflip.STREAM.rsplit("/tests/", 1)[0]


def _sweep(device, positions):
    """Run the sweep in child processes, resuming after a case that
    killed one; returns (raw or untagged cases, native crashes)."""
    bad, crashes = [], []
    start = 0
    while True:
        r = subprocess.run(
            [sys.executable, "-m", "turingcodec_tpu_torch.tools.bitflip",
             "--device", device, "--positions", positions, "--start",
             str(start)], cwd=REPO, capture_output=True, text=True,
            timeout=900)
        last_at = None
        for line in r.stdout.splitlines():
            if line.startswith("AT "):
                last_at = tuple(int(x) for x in line.split()[1:3])
            elif line.startswith(("RAW ", "UNTAGGED ")):
                bad.append(line)
        if "DONE" in r.stdout:
            break
        crashes.append((last_at, r.returncode, r.stderr[-300:]))
        if last_at is None:
            break
        start = last_at[0] + 1   # resume after the killer position
    return bad, crashes


@pytest.mark.parametrize("positions", ["header", "slice"])
def test_bitflips_never_crash(positions):
    bad, crashes = _sweep("none", positions)
    assert not crashes, f"native crashes at {crashes[:6]}"
    assert not bad, bad[:6]


def test_bitflip_outcomes_match_the_jax_decoder():
    """On the header positions the port's host decode ends as the JAX
    decoder's: the same Violation clause, or the same planes, hash
    failures and recorded violations."""
    from turingcodec_tpu.decode.decoder import Decoder as JaxDecoder
    from turingcodec_tpu.decode.violations import Violation
    import numpy as np
    data = open(bitflip.STREAM, "rb").read()
    kinds = set()
    for pos in bitflip.POSITIONS["header"][::2]:
        mut = bitflip.flipped(data, pos, 0x01)
        try:
            dec = JaxDecoder()
            want = ("decoded", [[np.asarray(p) for p in f.planes]
                                for f in dec.decode_stream(
                                    mut, max_frames=bitflip.MAX_FRAMES)],
                    dec.hash_failures, list(dec.violations))
        except Violation as v:
            want = ("violation", v.clause, str(v))
        got = bitflip.outcome(mut, None)
        assert bitflip.same(got, want), (pos, got[0], want[0])
        kinds.add(got[0])
    assert kinds == {"violation", "decoded"}


def test_violation_is_clause_tagged():
    """Violations are recorded (header NALs: record-and-skip) or raised
    (slice data); both carry the spec clause tag."""
    data = open(bitflip.STREAM, "rb").read()
    seen = 0
    for pos in range(10, 80, 4):
        got = bitflip.outcome(bitflip.flipped(data, pos, 0x20), None, 1)
        if got[0] == "violation":
            assert bitflip.tagged(got[1]), got[1]
            seen += 1
        else:
            seen += sum(1 for v in got[3] if "[" in v and "]" in v)
    assert seen >= 3, f"only {seen} clause-tagged violations seen"
