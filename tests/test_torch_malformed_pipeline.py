"""tests/test_torch_malformed.py's bit-flip sweep through the port's
device pipeline on the CPU (device="cpu": the kernels' plain versions).
The slice-data flips run in a child process: every flipped vfy_sweep
stream ends in a clause-tagged Violation or a decode, never a raw
exception or a native crash. A header flip changes only what the host
parser reads (its sweep in a child process is in test_torch_malformed.py);
here the header flips of chip_smoke.py's card phase (bit 0x01) end
through the pipeline as they end on the host path."""
import pytest

from tests.test_torch_malformed import _sweep
from turingcodec_tpu_torch.tools import bitflip


@pytest.mark.parametrize("positions", ["slice"])
def test_bitflips_never_crash_in_the_pipeline(positions):
    bad, crashes = _sweep("cpu", positions)
    assert not crashes, f"native crashes at {crashes[:6]}"
    assert not bad, bad[:6]


def test_header_flips_end_in_the_pipeline_as_on_the_host():
    data = open(bitflip.STREAM, "rb").read()
    kinds = set()
    for pos in bitflip.POSITIONS["header"][::2]:
        mut = bitflip.flipped(data, pos, 0x01)
        got = bitflip.outcome(mut, "cpu")
        want = bitflip.outcome(mut, None)
        assert bitflip.same(got, want), (pos, got[0], want[0])
        assert got[0] == "decoded" or bitflip.tagged(got[1]), got[2]
        kinds.add(got[0])
    assert kinds == {"violation", "decoded"}
