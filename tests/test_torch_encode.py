"""The port's encoder end to end against the JAX package: the same frames
and EncoderConfig give byte-identical bitstreams with the analysis stage
on a torch device (device="cpu": the plain versions of the kernels), on
the host (device=None), and in the JAX package with its device stage on
(TURING_TPU_DEVICE_ENC=1). The port's decoder decodes the result
hash-clean, and the port runs without loading jax."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n, w, h, seed=11):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + 16, w + 16)).astype(np.int16)
    out = []
    for i in range(n):
        out.append([np.ascontiguousarray(base[i:i + h, i * 2:i * 2 + w]),
                    np.ascontiguousarray(base[:h // 2, :w // 2]),
                    np.ascontiguousarray(base[8:8 + h // 2, :w // 2])])
    return out


CFG = dict(width=128, height=96, qp=32, gop_m=4, sao=False, rdoq=True,
           sdh=True, rd_candidates=2)


def _encode(mod, frames, **kw):
    enc = mod.Encoder(mod.EncoderConfig(**{**CFG, **kw}))
    out = [enc.headers()]
    for f in frames:
        for (_i, nal, _r) in enc.push_frame([p.copy() for p in f]):
            out.append(nal)
    for (_i, nal, _r) in enc.flush():
        out.append(nal)
    return b"".join(out)


@pytest.fixture(scope="module")
def jax_stream():
    import turingcodec_tpu.encode.encoder as jenc
    old = os.environ.get("TURING_TPU_DEVICE_ENC")
    os.environ["TURING_TPU_DEVICE_ENC"] = "1"
    try:
        return _encode(jenc, _frames(5, 128, 96))
    finally:
        if old is None:
            os.environ.pop("TURING_TPU_DEVICE_ENC")
        else:
            os.environ["TURING_TPU_DEVICE_ENC"] = old


@pytest.mark.parametrize("device", [None, "cpu"])
def test_port_encode_matches_jax_device_encode(jax_stream, device,
                                               monkeypatch):
    import turingcodec_tpu_torch.encode.device_analysis as tda
    import turingcodec_tpu_torch.encode.encoder as tenc
    from turingcodec_tpu_torch.decode.decoder import Decoder
    calls = []
    sweep = tda.dense_me_sweep
    monkeypatch.setattr(tda, "dense_me_sweep",
                        lambda *a, **k: calls.append(1) or sweep(*a, **k))
    got = _encode(tenc, _frames(5, 128, 96), device=device)
    assert got == jax_stream
    # the stage ran once per inter picture and reference list, or never
    assert len(calls) >= (4 if device else 0) and (device or not calls)
    dec = Decoder(device=None)
    n = sum(1 for _ in dec.decode_stream(got))
    assert n == 5 and dec.hash_failures == 0


@pytest.mark.parametrize("bd", [13, 14, 16])
def test_port_encodes_deep_samples_as_jax_does(bd):
    """The JAX encoder takes samples up to 16 bits (its analysis planes
    are int16) and the port encodes them too, byte-identical on the host
    path and with the analysis stage on a device, whose dense sweep takes
    the 64-bit key above 12 bits."""
    import turingcodec_tpu.encode.encoder as jenc
    import turingcodec_tpu_torch.encode.encoder as tenc
    frames = [[(p.astype(np.int32) << (bd - 8)) for p in f]
              for f in _frames(3, 128, 96)]
    cfg = dict(bit_depth=bd, gop_m=1)
    old = os.environ.get("TURING_TPU_DEVICE_ENC")
    os.environ["TURING_TPU_DEVICE_ENC"] = "1"
    try:
        want = _encode(jenc, frames, **cfg)
    finally:
        if old is None:
            os.environ.pop("TURING_TPU_DEVICE_ENC")
        else:
            os.environ["TURING_TPU_DEVICE_ENC"] = old
    assert _encode(tenc, frames, device=None, **cfg) == want
    assert _encode(tenc, frames, device="cpu", **cfg) == want


@pytest.mark.parametrize("tool", ["encode", "decode"])
def test_tools_default_to_the_card(tool, tmp_path, monkeypatch):
    """With no --device the CLI tools ask for the card and raise without
    one (nothing carries on on the CPU); --device none is the host path."""
    import json

    import torch

    from turingcodec_tpu_torch.tools import decode, encode
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.hevc"
    if tool == "encode":
        yuv = tmp_path / "in.yuv"
        yuv.write_bytes(np.random.RandomState(2).randint(
            0, 256, 2 * 64 * 64 * 3 // 2).astype(np.uint8).tobytes())
        main = encode.main
        argv = [str(yuv), "--input-res", "64x64", "-o", str(out),
                "--speed", "fast", "--no-progress"]
    else:
        streams = os.path.join(REPO, "tests", "streams")
        golden = json.load(open(os.path.join(streams, "GOLDEN.json")))
        main = decode.main
        argv = [os.path.join(streams, "static_test.hevc"), "--no-progress",
                "--md5", golden["static_test.hevc"]]
    with pytest.raises(RuntimeError):
        main(argv)
    assert not out.exists()
    assert main(argv + ["--device", "none"]) == 0
    assert tool == "decode" or out.stat().st_size > 0


NO_JAX = r"""
import sys
import numpy as np
from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
from turingcodec_tpu_torch.decode.decoder import Decoder
rng = np.random.RandomState(1)
base = rng.randint(0, 256, (80, 80)).astype(np.int16)
frames = [[base[i:i + 64, i:i + 64].copy(), base[:32, :32].copy(),
           base[8:40, :32].copy()] for i in range(2)]
enc = Encoder(EncoderConfig(width=64, height=64, qp=32, rd_candidates=2,
                            search_range=32, device="cpu"))
out = [enc.headers()]
for f in frames:
    out += [nal for (_i, nal, _r) in enc.push_frame(f)]
out += [nal for (_i, nal, _r) in enc.flush()]
dec = Decoder(device=None)
assert sum(1 for _ in dec.decode_stream(b"".join(out))) == 2
assert dec.hash_failures == 0
from turingcodec_tpu_torch.decode import device_pipeline
dec = Decoder(device="cpu")
assert sum(1 for _ in dec.decode_stream(b"".join(out))) == 2
assert dec.hash_failures == 0 and device_pipeline.pictures == 2
assert "torch" in sys.modules
import turingcodec_tpu_torch.ops.dense_me  # the kernels' modules loaded
import turingcodec_tpu_torch.ops.inter
import turingcodec_tpu_torch.ops.transform
from turingcodec_tpu_torch.tools import device_enc_check, kernels, testdecode
assert kernels.main(["--device", "cpu", "--batch", "4", "--iters", "1"]) == 0
assert testdecode.main(["--device", "none"]) == 0
from turingcodec_tpu_torch.encode.device_analysis import analysis_device
assert analysis_device(base[:64, :64], base[4:68, 2:66], "cpu",
                       want_surf=True)[5].shape == (16, 289)
# the batched stages, their tools and the entry points
from turingcodec_tpu_torch import entry
from turingcodec_tpu_torch.encode.device_analysis import (
    analysis_frames_batched)
from turingcodec_tpu_torch.parallel import gop_decode, mesh
from turingcodec_tpu_torch.tools import bdrate, scaling, signature
from turingcodec_tpu_torch.tools import bitflip, tool_matrix
assert tool_matrix.stream_facts(b"".join(out))["idr"] == 1
assert bitflip.outcome(b"".join(out), None)[0] == "decoded"
assert analysis_frames_batched(np.stack([base[:64, :64]] * 2),
                               np.stack([base[4:68, 2:66]] * 2), "cpu",
                               8)[1].shape == (2, 4, 4, 2)
assert scaling.main(["--device", "cpu", "--frames", "2"]) == 0
step, args = entry.entry("cpu")
assert step(*args)[0].shape == (8, 32, 32)
assert mesh.make_mesh(2, 1, "cpu").shape == {"frame": 2, "row": 1}
yuv, md5 = signature.decode_input(device=None)
assert md5 == signature.golden_md5()
assert signature.run_row("all-intra-q32", yuv, "cpu") == (
    *signature.want_of("all-intra-q32"), True)
assert bdrate.bd_rate([1, 2, 3], [30, 33, 36], [1, 2, 3], [30, 33, 36]) == 0
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "turingcodec_tpu" or m.startswith("turingcodec_tpu.")]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
