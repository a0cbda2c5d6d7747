"""The port's encoder analysis stages (turingcodec_tpu_torch.encode.
device_analysis, device="cpu": the same torch code as on the card, with
the kernels' plain versions) against the JAX package's device stages and
the host twins, on tests/test_device_enc.py's inputs and sizes. Every
value is an integer: equality is exact."""
import numpy as np
import pytest
import torch

import turingcodec_tpu.encode.device_analysis as jda
import turingcodec_tpu_torch.encode.device_analysis as tda
from turingcodec_tpu.encode.encoder import Encoder as JaxEncoder
from turingcodec_tpu.encode.encoder import EncoderConfig as JaxConfig


def _seed_inputs():
    rng = np.random.RandomState(3)
    # multiples of 16: the decimated planes fill the block grid, so only
    # the reference borders clamp; tests/test_torch_seed_field.py takes
    # sizes whose decimation clamps inside the grid
    h, w = 96, 144
    orig = rng.randint(0, 256, (h, w)).astype(np.int16)
    ref = np.roll(orig, (3, -5), (0, 1)).astype(np.int16)
    ref[40:60, 40:80] = rng.randint(0, 256, (20, 40))
    return orig, ref


def _dense_inputs():
    rng = np.random.RandomState(5)
    h, w = 112, 176   # non-multiples of 64 exercise the padding
    orig = rng.randint(0, 256, (h, w)).astype(np.int16)
    ref = np.roll(orig, (-7, 9), (0, 1)).astype(np.int16)
    ref[30:70, 50:120] = rng.randint(0, 256, (40, 70))
    return orig, ref


def test_seed_field_matches_jax_and_host():
    from turingcodec_tpu_torch.encode.inter_search import InterPictureEncoder
    orig, ref = _seed_inputs()
    got, wb, hb = tda.seed_field_device(orig, ref, "cpu")
    want, wb_j, hb_j = jda.seed_field_device(orig, ref)
    assert (wb, hb) == (wb_j, hb_j)
    assert got.dtype == np.int32 and got.shape == (hb, wb, 2)
    np.testing.assert_array_equal(got, want)
    enc = InterPictureEncoder.__new__(InterPictureEncoder)
    enc._lr_seed_cache = {}
    enc.orig = [orig]
    host, wb_h, hb_h = enc._lowres_seed_field(ref)
    assert (wb_h, hb_h) == (wb, hb)
    np.testing.assert_array_equal(got, host)


def test_dense_field_matches_jax_and_native():
    from turingcodec_tpu_torch import native
    orig, ref = _dense_inputs()
    got = tda.analysis_device(orig, ref, "cpu")
    want = jda.analysis_device(orig, ref)
    assert got[3:] == want[3:]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    res = native.dense_analysis(orig, ref, 8)
    assert res is not None, "native core unavailable"
    for g, n in zip(got[:3], res[:3]):
        np.testing.assert_array_equal(g, n)


@pytest.mark.parametrize("bd", [8, 10])
def test_subpel_planes_match_jax_and_host(bd):
    rng = np.random.RandomState(7)
    h, w = 22, 37
    ref = rng.randint(0, 1 << bd, (h, w)).astype(np.int16)
    got = tda.subpel_planes_device(ref, bd, "cpu")
    assert got.dtype == np.int16
    assert got.shape == (15, h + 2 * tda.SP_P, w + 2 * tda.SP_P)
    np.testing.assert_array_equal(got, jda.subpel_planes_device(ref, bd))
    np.testing.assert_array_equal(got, jda.subpel_planes_host(ref, bd))
    np.testing.assert_array_equal(tda.subpel_planes_host(ref, bd), got)


@pytest.fixture(scope="module")
def rank_tables():
    rng = np.random.RandomState(5)
    w, h = 128, 96
    plane = rng.randint(0, 256, (h, w)).astype(np.int16)
    plane[20:60, 30:100] = (np.add.outer(np.arange(40), np.arange(70))
                            % 256)
    zscan = JaxEncoder(JaxConfig(width=w, height=h, qp=32,
                                 rd_candidates=2)).geom.zscan
    return {"port_device": tda.rank_satd_tables_device(plane, zscan, 8,
                                                       True, "cpu"),
            "port_host": tda.rank_satd_tables_host(plane, zscan, 8, True),
            "jax_device": jda.rank_satd_tables_device(plane, zscan, 8, True),
            "jax_host": jda.rank_satd_tables_host(plane, zscan, 8, True)}


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rank_satd_tables_match_jax_and_host(rank_tables, n):
    got = rank_tables["port_device"][n]
    assert got.dtype == np.int32 and got.shape == (96 // n, 128 // n, 35)
    for other in ("port_host", "jax_device", "jax_host"):
        np.testing.assert_array_equal(got, rank_tables[other][n],
                                      err_msg=other)


def test_cuda_without_a_card_raises(monkeypatch):
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tda.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Encoder(EncoderConfig(width=64, height=64, device="cuda"))
    with pytest.raises(RuntimeError):  # the default asks for the card
        EncoderConfig(width=64, height=64)
    assert EncoderConfig(width=64, height=64, device=None).device is None
    assert tda.resolve_device(None) is None
    assert tda.resolve_device("cpu") == torch.device("cpu")


def test_device_enc_enabled_follows_the_device():
    dev = torch.device("cpu")
    assert tda.device_enc_enabled(dev)
    assert not tda.device_enc_enabled(None)


# search switches that no test, tool row or benchmark set, retired with
# the second paths they kept
RETIRED_SWITCHES = (
    "TC_NO_SATDGATE", "TC_SRC_RANK", "TC_NO_SRC_RANK", "TC_NO_II",
    "TC_SATD_I16", "TC_NO_DENSEME", "TC_NO_LOWRES", "TC_NO_SUBPEL_PLANES",
    "TC_SRC_SEEDS", "TC_NO_NOISE_ADAPT", "TURING_TPU_NO_NATIVE_RECON",
    "TURING_TPU_NO_NATIVE_WRITE", "TURING_TPU_NO_NATIVE_PARSE",
    "TURING_TPU_FRAME_OVERLAP", "CABAC_TRACE_PY")


def test_no_source_of_the_port_names_a_retired_switch():
    import pathlib
    import re
    pat = re.compile(r"\b(" + "|".join(RETIRED_SWITCHES) + r")\b")
    root = pathlib.Path(tda.__file__).resolve().parents[1]
    found = [f"{path.relative_to(root)}:{i}: {m.group(1)}"
             for path in sorted(root.rglob("*"))
             if path.suffix in (".py", ".cpp", ".h", ".cu")
             for i, line in enumerate(path.read_text().splitlines(), 1)
             for m in pat.finditer(line)]
    assert not found, found


def test_dense_surface_matches_jax_and_native():
    """want_surf: the (hb*wb, 289) SAD surface on the port's device path
    equals the JAX package's want_surf surface and the native prepass's
    out_surf (the table the host path's full-pel search reads), and the
    other five values are those of want_surf=False."""
    from turingcodec_tpu_torch import native
    orig, ref = _dense_inputs()
    got = tda.analysis_device(orig, ref, "cpu", want_surf=True)
    want = jda.analysis_device(orig, ref, want_surf=True)
    assert len(got) == 6 and got[3:5] == want[3:5]
    assert got[5].dtype == np.int32 and got[5].shape == (77, 289)
    for g, w in zip(got[:3] + got[5:], want[:3] + want[5:]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[:5], tda.analysis_device(orig, ref, "cpu")):
        np.testing.assert_array_equal(g, w)
    res = native.dense_analysis(orig, ref, 8)
    assert res is not None and res[5] is not None
    np.testing.assert_array_equal(got[5], res[5])


def _enc_frames(n, w, h, seed=11):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + 16, w + 16)).astype(np.int16)
    return [[np.ascontiguousarray(base[i:i + h, i * 2:i * 2 + w]),
             np.ascontiguousarray(base[:h // 2, :w // 2]),
             np.ascontiguousarray(base[8:8 + h // 2, :w // 2])]
            for i in range(n)]


@pytest.mark.parametrize("no_surf", [False, True])
def test_encode_installs_one_surface_per_inter_picture(no_surf,
                                                       monkeypatch):
    """The low-delay encode with the stage on the device computes one
    surface per inter picture (both lists hold the same picture, and share
    it) and hands it to the native install for both lists, unless
    TC_NO_ME_SURF is set, as on the host prepass; the bitstream is
    byte-identical to the host path's either way."""
    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    if no_surf:
        monkeypatch.setenv("TC_NO_ME_SURF", "1")
    else:
        monkeypatch.delenv("TC_NO_ME_SURF", raising=False)
    installed = []
    real = native.EncNative.install_seeds

    def spy(self, fields):
        installed.append({lx: f[4] for lx, f in fields.items()})
        return real(self, fields)

    monkeypatch.setattr(native.EncNative, "install_seeds", spy)
    frames = _enc_frames(4, 128, 96)

    def encode(device):
        enc = Encoder(EncoderConfig(width=128, height=96, qp=32, gop_m=1,
                                    sao=False, rdoq=True, sdh=True,
                                    rd_candidates=2, search_range=32,
                                    device=device))
        out = [enc.headers()]
        for f in frames:
            out += [nal for (_i, nal, _r) in enc.push_frame(
                [p.copy() for p in f])]
        out += [nal for (_i, nal, _r) in enc.flush()]
        return b"".join(out)

    monkeypatch.setattr(tda, "surfaces", 0)
    got = encode("cpu")
    assert tda.surfaces == (0 if no_surf else 3)
    inter = [d for d in installed if d]
    assert len(inter) == 3 and all(sorted(d) == [0, 1] for d in inter)
    for d in inter:
        if no_surf:
            assert d[0] is None and d[1] is None
        else:
            assert d[0].shape == (48, 289) and d[1] is d[0]
    installed.clear()
    assert got == encode(None)


def test_encode_keeps_no_installed_surface(monkeypatch):
    """The native core copies the fields it is given, so a picture's seed
    and dense fields and its 289-SAD surface die with the picture: over a
    six-picture encode with the stage on the device, at most the last
    inter picture's surface is still alive."""
    import gc
    import weakref

    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    monkeypatch.delenv("TC_NO_ME_SURF", raising=False)
    refs = []
    real = native.EncNative.install_seeds

    def spy(self, fields):
        surfs = {id(f[4]): f[4] for f in fields.values() if f[4] is not None}
        refs.extend(weakref.ref(s) for s in surfs.values())
        return real(self, fields)

    monkeypatch.setattr(native.EncNative, "install_seeds", spy)
    enc = Encoder(EncoderConfig(width=128, height=96, qp=32, gop_m=1,
                                sao=False, rdoq=True, sdh=True,
                                rd_candidates=1, search_range=32,
                                device="cpu"))
    enc.headers()
    for f in _enc_frames(6, 128, 96):
        enc.push_frame([p.copy() for p in f])
    enc.flush()
    gc.collect()
    assert len(refs) == 5
    assert sum(r() is not None for r in refs) <= 1


def test_search_installs_the_records_products(monkeypatch):
    """A three-picture low-delay encode with the stage on "cpu": the
    native core is handed exactly the seed fields, subpel planes and
    rank-SATD tables that the facade put in each picture's record
    (intra_search.SearchInputs), and the bytes equal the host path's."""
    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    records, installed = [], {"seeds": [], "subpel": [], "rank_tables": []}
    fill = Encoder._fill_search_inputs

    def keep(self, docket, enc, *a):
        fill(self, docket, enc, *a)
        records.append(enc.inputs)

    monkeypatch.setattr(Encoder, "_fill_search_inputs", keep)
    for name, key in (("install_seeds", "seeds"),
                      ("install_subpel", "subpel"),
                      ("install_ranksatd", "rank_tables")):
        def spy(self, products, real=getattr(native.EncNative, name),
                key=key):
            installed[key].append(products)
            return real(self, products)
        monkeypatch.setattr(native.EncNative, name, spy)
    frames = _enc_frames(3, 128, 96, seed=5)

    def encode(device):
        enc = Encoder(EncoderConfig(width=128, height=96, qp=32, gop_m=1,
                                    sao=False, rdoq=True, sdh=True,
                                    rd_candidates=1, search_range=32,
                                    device=device))
        out = [enc.headers()]
        for f in frames:
            out += [nal for (_i, nal, _r) in enc.push_frame(
                [p.copy() for p in f])]
        out += [nal for (_i, nal, _r) in enc.flush()]
        return b"".join(out)

    got = encode("cpu")
    assert len(records) == 3
    for key, n in (("seeds", 2), ("subpel", 2), ("rank_tables", 3)):
        want = [getattr(r, key) for r in records if getattr(r, key)]
        assert len(want) == n, key
        assert len(installed[key]) == n, key
        assert all(a is b for a, b in zip(installed[key], want)), key
    assert all(sorted(r.seeds) == [0, 1] for r in records[1:])
    assert not records[0].seeds and not records[0].subpel
    assert got == encode(None)
