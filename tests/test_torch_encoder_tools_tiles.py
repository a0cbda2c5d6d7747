"""The tool matrix's tile and transform-skip rows
(turingcodec_tpu_torch/tools/tool_matrix.py) held against the JAX package
on their small inputs, tolerance 0, as tests/test_torch_encoder_tools.py
holds the other rows: the port's bitstream with device=None and "cpu"
equal to the JAX encoder's (analysis stage on), its decode on the same
device equal to the JAX decoder's. Both encodes run the pure-Python CTU
searcher in each package (the native search steps aside for tiles and
transform skip), about 7 s an encode."""
import pytest

from tests.test_torch_encoder_tools import check_row
from turingcodec_tpu_torch.tools.device_enc_check import decode_inputs

ROWS = ["tiles-2x2", "tskip"]


@pytest.fixture(scope="module")
def clip():
    return decode_inputs(2, 1)


@pytest.fixture(scope="module")
def jax_cache():
    return {}


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("name", ROWS)
def test_tool_row_matches_jax(name, device, clip, jax_cache):
    check_row(name, device, clip, jax_cache)
