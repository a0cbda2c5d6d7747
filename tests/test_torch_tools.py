"""The port's tools on the CPU: tools.kernels (the `turing havoc`
analogue) runs its self-test with the kernels' plain versions,
tools.testdecode checks GOLDEN streams, tools.device_enc_check holds the
analysis stage against its host twins, and each asks for the card by
default and raises without one."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from turingcodec_tpu_torch.tools import device_enc_check, kernels, testdecode

STREAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "streams")


def test_kernels_self_test_passes_on_the_cpu(capsys):
    assert kernels.main(["--device", "cpu", "--batch", "8",
                         "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "ALL OK" in out and "FAIL" not in out
    for row in ("forward_dct_32x32", "dequant_idct_4x4",
                "dequant_idct_32x32", "quant_16x16", "satd8_16x16",
                "intra35_32x32", "interp16_luma_16x16", "satd8_native"):
        assert row in out


def test_kernels_residual_rows_take_the_kernels_entry_point(monkeypatch):
    """The residual rows go through dequant_idct_add, the entry point that
    launches csrc/dequant_idct.cu on the card, for each TU size."""
    from turingcodec_tpu_torch.ops import transform
    calls = []
    real = transform.dequant_idct_add

    def spy(coeff, planes, table, bds):
        calls.append(len(table))
        return real(coeff, planes, table, bds)

    monkeypatch.setattr(transform, "dequant_idct_add", spy)
    assert kernels.main(["--device", "cpu", "--batch", "5",
                         "--iters", "1"]) == 0
    # the check and the warm-up and timed calls of _bench, per size
    assert calls == [5] * 12


@pytest.mark.cuda
def test_kernels_self_test_launches_the_kernels_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from turingcodec_tpu_torch.ops import inter, transform
    transform.launches = transform.fwd_launches = inter.interp_launches = 0
    assert kernels.main(["--batch", "64", "--iters", "1"]) == 0
    assert "ALL OK" in capsys.readouterr().out
    assert transform.launches == 12 and transform.fwd_launches == 12
    assert inter.interp_launches == 3


@pytest.mark.parametrize("device", ["none", "cpu"])
def test_testdecode_passes_on_golden_streams(device, tmp_path, capsys):
    """A corpus of two GOLDEN streams with their .md5 files."""
    golden = json.load(open(os.path.join(STREAMS, "GOLDEN.json")))
    names = ["static_test.hevc", "vfy_hp.hevc"]
    for n in names:
        shutil.copy(os.path.join(STREAMS, n), tmp_path / n)
        (tmp_path / n).with_suffix(".md5").write_text(golden[n] + "\n")
    assert testdecode.main(["--device", device, "--corpus",
                            str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "2/2 streams OK" in out
    assert all(f"ok    {n}" in out for n in names)


def test_testdecode_checks_tests_streams_by_default(capsys):
    assert testdecode.main(["--device", "none"]) == 0
    out = capsys.readouterr().out
    assert "10/10 streams OK" in out and "?" not in out


def test_testdecode_fails_on_a_wrong_golden(tmp_path, capsys):
    s = tmp_path / "static_test.hevc"
    s.write_bytes(open(os.path.join(STREAMS, "static_test.hevc"),
                       "rb").read())
    (tmp_path / "static_test.md5").write_text("0" * 32 + "\n")
    assert testdecode.main(["--device", "none", "--corpus",
                            str(tmp_path)]) == 1
    assert "FAIL  static_test.hevc: md5" in capsys.readouterr().out


@pytest.mark.parametrize("tool", [kernels, testdecode, device_enc_check])
def test_tools_default_to_the_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tool.main([])


def test_device_enc_check_analysis_on_the_cpu():
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    rng = np.random.RandomState(5)
    h, w = 112, 176
    orig = rng.randint(0, 256, (h, w)).astype(np.int16)
    ref = np.roll(orig, (-7, 9), (0, 1)).astype(np.int16)
    ref[30:70, 50:120] = rng.randint(0, 256, (40, 70))
    zscan = Encoder(EncoderConfig(width=w, height=h, qp=30,
                                  rd_candidates=1, device=None)).geom.zscan
    lines = []
    assert device_enc_check.analysis_checks(orig, ref, zscan, "cpu", 0,
                                            lines.append) == {}
    assert any("SAD surface" in ln for ln in lines)


def test_device_enc_check_encode_turns_on_the_cpu():
    """Four turns with SAD surfaces and with TC_NO_ME_SURF, the stage on
    the device and on the host: eight identical bitstreams, one surface per
    inter picture with surfaces (encode_turns checks both)."""
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (112, 160)).astype(np.int16)
    frames = [[np.ascontiguousarray(base[i:i + 96, 2 * i:2 * i + 128]),
               base[:48, :64].copy(), base[8:56, :64].copy()]
              for i in range(3)]
    lines = []
    fps = device_enc_check.encode_turns(frames, "cpu", lines.append)
    assert sorted(fps) == [("off", "device"), ("off", "host"),
                           ("on", "device"), ("on", "host")]
    assert all(len(v) == 2 and min(v) > 0 for v in fps.values())
    assert "all eight bitstreams identical" in lines[0]
