"""The port's tools over the batched stages and its entry points:
tools/scaling.py, tools/bdrate.py and entry.py on in-repo data, against
the JAX package where it has the same function (bd_rate, psnr_y, entry's
step) and against the port's per-picture and host paths; exact (tolerance
0). The JAX package is imported inside the tests only: the tests marked
cuda run on the card's machine, which has no jax."""
import os

import numpy as np
import pytest
import torch

from turingcodec_tpu_torch import entry as tentry
from turingcodec_tpu_torch.tools import bdrate, scaling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs an NVIDIA GPU with nvcc")


@pytest.mark.parametrize("argv", [[], ["--frames", "8", "--mesh", "2x2"]])
def test_scaling_batched_mc_equals_per_picture(argv, capsys):
    assert scaling.main(argv + ["--device", "cpu"]) == 0
    assert "batched == per-picture: BIT-EXACT" in capsys.readouterr().out


@pytest.mark.parametrize("tool", [scaling, bdrate, tentry])
def test_tools_default_to_the_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tool.main([])


def test_bd_rate_and_psnr_match_jax():
    from turingcodec_tpu.tools import bdrate as jbd
    r_ref, p_ref = [9000, 5200, 3100, 1900], [41.2, 38.0, 35.1, 32.4]
    r_test, p_test = [8600, 5100, 2950, 1850], [41.0, 38.1, 35.0, 32.6]
    got = bdrate.bd_rate(r_ref[::-1], p_ref[::-1], r_test[::-1],
                         p_test[::-1])
    assert got == jbd.bd_rate(r_ref[::-1], p_ref[::-1], r_test[::-1],
                              p_test[::-1])
    assert -10 < got < 0
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (36, 64)).astype(np.int16)
    b = np.clip(a + rng.integers(-5, 6, a.shape), 0, 255).astype(np.int16)
    assert bdrate.psnr_y(a, b) == jbd.psnr_y(a, b)
    assert bdrate.psnr_y(a, a) == jbd.psnr_y(a, a) == 99.0


def test_run_ours_gives_identical_bytes_on_host_and_device():
    frames = bdrate.decode_clip(3)
    assert [p.shape for p in frames[0]] == [(360, 640), (180, 320),
                                            (180, 320)]
    host = bdrate.encode_ours(frames, 34, "fast", 1, None)[0]
    dev = bdrate.encode_ours(frames, 34, "fast", 1, "cpu")[0]
    assert host == dev
    n, psnr, fps = bdrate.run_ours(frames, 34, "fast", 1, None)
    assert n == len(host) and 25 < psnr < 60 and fps > 0
    up = bdrate.upscale3(frames[:1])
    assert [p.shape for p in up[0]] == [(1080, 1920), (540, 960), (540, 960)]


def _tree(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in (".git", "__pycache__")]
        for f in files:
            p = os.path.join(d, f)
            out[p] = os.stat(p).st_mtime_ns
    return out


def test_bdrate_writes_nothing_into_the_repo(monkeypatch, tmp_path, capsys):
    """Without --out/--json and without the reference binary the tool
    prints our points and writes no file, in the repo or the working
    directory; --out writes where it is told."""
    monkeypatch.setattr(bdrate, "REF_BIN", str(tmp_path / "absent"))
    monkeypatch.setattr(bdrate, "QPS", (30, 38))
    monkeypatch.setattr(bdrate, "POINTS", (("fast", 1, "fast-LDP"),))
    monkeypatch.setattr(bdrate, "load_sequences",
                        lambda quick: {"synthetic": bdrate.synthetic(3,
                                                                     64, 64)})
    monkeypatch.chdir(tmp_path)
    before = _tree(REPO)
    assert bdrate.main(["--device", "none"]) == 0
    out = capsys.readouterr().out
    assert "absent: our points only" in out and "synthetic/fast-LDP qp38" in out
    assert _tree(REPO) == before and os.listdir(tmp_path) == []
    report = tmp_path / "sub.md"
    assert bdrate.main(["--device", "none", "--out", str(report)]) == 0
    assert "our points alone" in report.read_text()
    assert _tree(REPO) == before


def test_entry_step_matches_the_jax_entry():
    import jax

    import __graft_entry__ as g
    jfn, jargs = g.entry()
    jl, jr, js = jax.jit(jfn)(*jargs)
    step, args = tentry.entry("cpu")
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    levels, rate, satd = step(*args)
    assert levels.shape == (8, 32, 32)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(satd.numpy(), np.asarray(js))


def test_entry_dryrun_on_the_cpu():
    done = tentry.dryrun(2, 1, "cpu", log=lambda _m: None)
    assert done == ["analysis_step", "sharded_gop_mc", "sharded_gop_residual",
                    "sharded_gop_deblock", "sharded_gop_sao",
                    "seed_fields_frames_sharded", "analysis_frames_sharded",
                    "overlap_encode"]


@pytest.mark.cuda
@needs_card
def test_dense_me_wide_key_on_the_card():
    """At 14 bits the kernel's 64-bit key gives its plain version's
    winners where costs straddle 2^23; the 32-bit instance would not."""
    from turingcodec_tpu_torch.ops import dense_me
    rng = np.random.default_rng(5)
    cur = torch.full((64, 16, 16), 16383, dtype=torch.int32)
    pat = torch.full((64, 32, 32), 16383 - 8400, dtype=torch.int32)
    pat[:, 8:24, 8:24] = 16383 - 8000
    pat += torch.from_numpy(rng.integers(-3, 1, pat.shape).astype(np.int32))
    cur, pat = cur.cuda(), pat.cuda()
    want = dense_me.dense_me_argmin_ref(cur, pat)
    dense_me.launches = 0
    got = dense_me.dense_me_argmin(cur, pat, bit_depth=14)
    assert torch.equal(got, want) and dense_me.launches == 1
    assert (want[:, :2] == 0).all()
    assert not torch.equal(dense_me.dense_me_argmin(cur, pat, bit_depth=12),
                           want)


@pytest.mark.cuda
@needs_card
def test_gop_mc_is_one_launch_on_the_card():
    from turingcodec_tpu_torch.ops import inter
    from turingcodec_tpu_torch.ops.inter import mc_block_grid
    from turingcodec_tpu_torch.parallel.gop_decode import gop_mc
    with open(scaling.STREAM, "rb") as f:
        works = scaling.gather_workloads(f.read(), 7)
    refs, cols, nb = scaling.stack_workloads(works)
    args = [torch.from_numpy(cols[k]).cuda()
            for k in ("sel", "xi", "yi", "xf", "yf")]
    inter.launches = 0
    got = gop_mc(torch.from_numpy(refs).cuda(), *args)
    assert inter.launches == 1
    for i, wk in enumerate(works):
        a = [torch.from_numpy(np.asarray(wk[k], np.int32)[None]).cuda()
             for k in ("sel", "xi", "yi", "xf", "yf")]
        want = mc_block_grid([[torch.from_numpy(wk["refs"]).cuda()]], *a,
                             4, 8, 8)[0, 0]
        assert torch.equal(got[i, :nb[i]], want)
