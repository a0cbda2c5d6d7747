"""The port's signature tool (turingcodec_tpu_torch/tools/signature.py) on
tests/streams/vfy_sweep.hevc: its pinned goldens are the JAX package's own
run on the same clip, and the port reproduces every row of the
configuration matrix on the host path (device=None) and the all-intra,
low-delay, 10-bit and field rows with the analysis stage and the decode on
a torch device (device="cpu": the kernels' plain versions), with the
encoder's recon equal to the port's decode. Exact hashes (tolerance 0)."""
import re

import pytest
import torch

from turingcodec_tpu_torch.tools import signature as tsig

ROW_NAMES = [row[0] for row in tsig.CONFIGS]
# a "cpu" row costs about 2.5 s per 640x360 frame: these four, the rest of
# the matrix on "cpu" in the slow test
CPU_ROWS = ["all-intra-q32", "lowdelay-q32", "10bit-q32", "field-q32"]


@pytest.fixture(scope="module")
def clip():
    yuv, md5 = tsig.decode_input(device=None)
    assert md5 == tsig.golden_md5()
    assert len(yuv) == 9 * tsig.WIDTH * tsig.HEIGHT * 3 // 2
    return yuv


def test_goldens_are_the_jax_packages_on_the_same_clip(monkeypatch, capsys):
    """The JAX package's signature run(update=True), pointed at vfy_sweep,
    measures exactly the goldens the port pins, row for row (the shared
    rows included)."""
    import turingcodec_tpu.tools.signature as jsig
    monkeypatch.setattr(jsig, "STREAM", tsig.STREAM)
    assert jsig.run(update=True) == 0
    out = capsys.readouterr().out
    assert f"decode md5(24): {tsig.golden_md5()}" in out
    measured = {name: (bits, rec) for name, bits, rec in re.findall(
        r"^\s*(\S+): bits (\w{8})  recon (\w{8})  OK$", out, re.M)}
    assert [row[0] for row in jsig.CONFIGS] == ROW_NAMES
    assert measured == {name: tsig.want_of(name) for name in ROW_NAMES}


@pytest.mark.parametrize("name", ROW_NAMES)
def test_signature_row_on_the_host_path(name, clip):
    bits, rec, ok = tsig.run_row(name, clip, None)
    assert ok, f"{name}: recon differs from the decode"
    assert (bits, rec) == tsig.want_of(name)


@pytest.mark.parametrize("name", CPU_ROWS)
def test_signature_row_on_the_cpu_device(name, clip):
    bits, rec, ok = tsig.run_row(name, clip, "cpu")
    assert ok, f"{name}: recon differs from the decode"
    assert (bits, rec) == tsig.want_of(name)


@pytest.mark.slow
def test_signature_matrix_on_the_cpu_device():
    assert tsig.main(["--device", "cpu"]) == 0


def test_signature_cli(capsys):
    assert tsig.main(["--device", "none", "--rows",
                      "all-intra-q32,no-wpp-q32"]) == 0
    out = capsys.readouterr().out
    assert "decode md5: 507bae42a89edf74abba639a6fa249ff OK" in out
    assert out.count(" OK") == 3


def test_signature_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsig.main([])
