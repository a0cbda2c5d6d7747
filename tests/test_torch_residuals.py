"""The port's one-call residual stage on the CPU (the kernel's plain
version), exact integers throughout:

- (a) decode/device_recon._residual_table, built with numpy from the
  parser's records, holds the same TUs as the plain walk
  `_residual_groups` (JAX `device_pipeline._residuals_device`'s loop) on
  every inter picture of the GOLDEN streams and of a stream with transform
  skip in inter CUs, from native records and from CuInfo objects alike;
- (b) the pipeline's `_residuals_device` equals the JAX package's on the
  same plan and motion-compensated planes of vfy_sweep;
- (c) ops/transform.dequant_idct_add_ref equals a numpy composition of the
  JAX `dequant_np` and `inverse_transform_batch`, with TUs at every edge;
- (d) one dequant_idct_add call per picture with coded inter TUs, none for
  a picture without;
- (e) bad inputs raise."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import turingcodec_tpu.decode.device_pipeline as jpipe
import turingcodec_tpu.ops.quant as jquant
import turingcodec_tpu.ops.transform as jtransform
import turingcodec_tpu_torch.decode.device_pipeline as dp
import turingcodec_tpu_torch.decode.device_recon as trecon
import turingcodec_tpu_torch.decode.picture_recon as picture_recon
import turingcodec_tpu_torch.ops.transform as ttransform
from turingcodec_tpu_torch.decode.decoder import Decoder
from turingcodec_tpu_torch.ops.transform import TU_KIND, tu_fields, tu_kind

T = torch.from_numpy
STREAMS = os.path.join(os.path.dirname(__file__), "streams")
GOLDEN = json.load(open(os.path.join(STREAMS, "GOLDEN.json")))
NAMES = [k for k in GOLDEN if not k.startswith("_")]


def _tskip_stream():
    """A small stream with transform skip in inter CUs (the port's encoder
    with --tskip tries it on the 4x4 chroma TBs of 8x8 inter CUs)."""
    from turingcodec_tpu_torch.encode.encoder import Encoder, EncoderConfig
    rng = np.random.RandomState(5)
    base = rng.randint(0, 256, (80, 80)).astype(np.int16)
    enc = Encoder(EncoderConfig(width=64, height=64, qp=27, rd_candidates=2,
                                tskip=True, sao=False, device=None))
    out = [enc.headers()]
    for i in range(3):
        f = [base[i:i + 64, 2 * i:2 * i + 64].copy(), base[:32, :32].copy(),
             base[8:40, :32].copy()]
        out += [nal for (_i, nal, _r) in enc.push_frame(f)]
    out += [nal for (_i, nal, _r) in enc.flush()]
    return b"".join(out)


def _stream(name):
    if name == "tskip":
        return _tskip_stream()
    return open(os.path.join(STREAMS, name), "rb").read()


def _rows_of_groups(groups):
    """_residual_groups' buckets as table rows, sorted."""
    rows = [(x, y, qp, tu_kind(c, lg, m))
            for (c, lg, m), items in groups.items() for (x, y, qp) in items]
    return _sorted(np.array(rows, np.int32).reshape(-1, 4))


def _sorted(table):
    return table[np.lexsort(table.T[::-1])]


def _has_inter(plan):
    return bool(((plan.cu_pred_mode == 0) & (plan.cu_id >= 0)).any())


@pytest.mark.parametrize("name", NAMES + ["tskip"])
def test_residual_table_matches_the_walk(name, monkeypatch):
    """(a): per picture, the table from the native records, the walk over
    the CuInfo objects, and the table from those objects agree (all three
    empty for a picture without inter CUs)."""
    seen = {"native": 0, "pictures": 0, "inter": 0, "modes": set(),
            "split_chroma": 0}
    run = picture_recon.PictureReconstructor.run

    def hooked(self):
        plan = self.plan
        native = plan.cu_list.record_arrays() is not None
        first = _sorted(trecon._residual_table(plan))
        want = _rows_of_groups(trecon._residual_groups(plan))
        assert plan.cu_list.record_arrays() is None  # now CuInfo objects
        from_objects = _sorted(trecon._residual_table(plan))
        np.testing.assert_array_equal(first, want)
        np.testing.assert_array_equal(from_objects, want)
        seen["native"] += native
        seen["pictures"] += 1
        seen["inter"] += _has_inter(plan)
        seen["modes"] |= set(tu_fields(want[:, TU_KIND])[2].tolist())
        seen["split_chroma"] += sum(
            1 for cu in plan.cu_list if cu.pred_mode == 0
            for t in cu.tus if t[2] == 2 and t[3] == 3 and any(t[7:]))
        return run(self)

    monkeypatch.setattr(picture_recon.PictureReconstructor, "run", hooked)
    for _f in Decoder(device=None).decode_stream(_stream(name)):
        pass
    assert seen["pictures"] > 0
    assert seen["native"] == seen["pictures"]  # the native parser ran
    if name == "tskip":
        # transform skip and split-8x8 chroma in inter CUs: no GOLDEN
        # stream has either
        assert seen["inter"] and 1 in seen["modes"] and seen["split_chroma"]


@pytest.fixture(scope="module")
def vfy_cpu():
    """One Decoder(device="cpu") decode of vfy_sweep, recording per picture
    the plan, the planes before and after `_residuals_device`, the size of
    its TU table, and the rows of each dequant_idct_add call."""
    rec = {"pics": [], "sizes": [], "calls": []}
    real = (dp._residuals_device, dp._residual_table, dp.dequant_idct_add)

    def residuals(plan, planes):
        before = [p.numpy().copy() for p in planes]
        got = [p.numpy().copy() for p in real[0](plan, planes)]
        rec["pics"].append((plan, before, got))
        return planes

    def table(plan):
        t = real[1](plan)
        rec["sizes"].append(len(t))
        return t

    def add(*a):
        rec["calls"].append(len(a[2]))
        return real[2](*a)

    dp._residuals_device, dp._residual_table, dp.dequant_idct_add = (
        residuals, table, add)
    dp.pictures = 0
    try:
        rec["n"] = sum(1 for _f in Decoder(device="cpu").decode_stream(
            _stream("vfy_sweep.hevc")))
    finally:
        dp._residuals_device, dp._residual_table, dp.dequant_idct_add = real
    rec["pictures"] = dp.pictures
    return rec


def test_residuals_device_matches_jax(vfy_cpu):
    """(b): the port's one call against the JAX package's size buckets on
    the same plan and MC'd planes, every inter picture of vfy_sweep."""
    inter = [p for p, n in zip(vfy_cpu["pics"], vfy_cpu["sizes"]) if n]
    assert len(inter) >= 3
    for plan, before, got in inter:
        want = jpipe._residuals_device(plan, [jnp.asarray(p) for p in before])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert any(not np.array_equal(g, b) for g, b in zip(got, before))


def _synthetic(rng, bd, h=88, w=120):
    """Level and predicted planes of a 4:2:0 picture whose height and width
    are not multiples of 32, and a table of disjoint TUs of every size and
    mode on every component, some touching the right and bottom edges."""
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    coeff, planes, rows = [], [], []
    qp_max = 51 + 6 * (bd - 8)
    for c, (hh, ww) in enumerate(shapes):
        lv = rng.integers(-300, 301, (hh, ww))
        big = rng.random((hh, ww)) < 0.05
        lv[big] = rng.choice([-32768, 32767], int(big.sum()))
        coeff.append(lv.astype(np.int16))
        planes.append(rng.integers(0, 1 << bd, (hh, ww)).astype(np.int16))
        for y0 in range(0, hh, 32):
            for x0 in range(0, ww, 32):
                inside = y0 + 32 <= hh and x0 + 32 <= ww
                lg = int(rng.integers(2, 6)) if inside else 2
                n = 1 << lg
                for y in range(y0, min(y0 + 32, hh - n + 1), n):
                    for x in range(x0, min(x0 + 32, ww - n + 1), n):
                        if rng.random() < 0.8:
                            rows.append((x, y, int(rng.integers(0, qp_max + 1)),
                                         tu_kind(c, lg, int(rng.integers(0, 3)))))
    table = np.array(rows, np.int32)
    comp, log2, _mode = tu_fields(table[:, TU_KIND])
    n = 1 << log2
    hw = np.array(shapes)[comp]
    assert ((table[:, 0] + n == hw[:, 1]).any()
            and (table[:, 1] + n == hw[:, 0]).any())
    return coeff, planes, table


def _numpy_residual_add(coeff, planes, table, bd):
    """The JAX package's arithmetic per TU: dequant_np, then
    inverse_transform_batch (mode 0), the transform-skip shift (mode 1) or
    the raw levels (mode 2), added and clipped."""
    out = [p.astype(np.int32) for p in planes]
    comp, log2, mode = tu_fields(table[:, TU_KIND])
    for c, lg, md in set(zip(comp.tolist(), log2.tolist(), mode.tolist())):
        sel = np.nonzero((comp == c) & (log2 == lg) & (mode == md))[0]
        n = 1 << lg
        lv = np.stack([coeff[c][y:y + n, x:x + n].astype(np.int32)
                       for x, y in table[sel, :2]])
        if md == 2:
            res = lv
        else:
            d = np.stack([jquant.dequant_np(a, int(q), bd, lg)
                          for a, q in zip(lv, table[sel, 2])])
            if md == 0:
                res = np.asarray(jtransform.inverse_transform_batch(
                    jnp.asarray(d), bd, False))
            else:
                sh = 20 - bd
                res = np.clip(((d.astype(np.int64) << 7) + (1 << (sh - 1)))
                              >> sh, -32768, 32767)
        for (x, y), r in zip(table[sel, :2], res):
            out[c][y:y + n, x:x + n] = np.clip(
                out[c][y:y + n, x:x + n] + r, 0, (1 << bd) - 1)
    return [o.astype(np.int16) for o in out]


@pytest.mark.parametrize("bd", [8, 10])
def test_dequant_idct_add_ref_matches_numpy_composition(bd):
    """(c), through the plain version and through the wrapper on CPU
    tensors (which launches nothing)."""
    coeff, planes, table = _synthetic(np.random.default_rng(bd), bd)
    modes = set(tu_fields(table[:, TU_KIND])[2].tolist())
    sizes = set(tu_fields(table[:, TU_KIND])[1].tolist())
    assert modes == {0, 1, 2} and sizes == {2, 3, 4, 5}
    want = _numpy_residual_add(coeff, planes, table, bd)
    before = ttransform.launches
    for fn in (ttransform.dequant_idct_add_ref, ttransform.dequant_idct_add):
        tp = [T(p.copy()) for p in planes]
        got = fn([T(c) for c in coeff], tp, table, (bd, bd, bd))
        for g, t, w in zip(got, tp, want):
            assert g is t  # in place
            np.testing.assert_array_equal(g.numpy(), w)
    assert ttransform.launches == before


def test_one_call_per_picture_with_coded_inter_tus(vfy_cpu):
    """(d): the pipeline calls dequant_idct_add once for each picture whose
    table has rows, and not at all for the others (the I picture)."""
    sizes = vfy_cpu["sizes"]
    assert vfy_cpu["pictures"] == vfy_cpu["n"] == len(sizes)
    assert 0 in sizes and vfy_cpu["calls"] == [s for s in sizes if s]


def _bad_inputs(bad):
    rng = np.random.default_rng(3)
    coeff, planes, table = _synthetic(rng, 8, 40, 72)
    coeff = [T(c) for c in coeff]
    planes = [T(p) for p in planes]
    bds = [8, 8, 8]
    row = table[0].copy()
    if bad == "plane dtype":
        planes[1] = planes[1].to(torch.int32)
    elif bad == "table dtype":
        table = table.astype(np.int64)
    elif bad == "table type":
        table = T(table)
    elif bad == "table shape":
        table = table[:, :3].copy()
    elif bad == "device":
        planes[2] = torch.empty(planes[2].shape, dtype=torch.int16,
                                device="meta")
    elif bad == "unsupported device":
        coeff = [torch.empty(c.shape, dtype=torch.int16, device="meta")
                 for c in coeff]
        planes = [torch.empty(p.shape, dtype=torch.int16, device="meta")
                  for p in planes]
    elif bad == "contiguous":
        coeff[0] = T(np.ascontiguousarray(coeff[0].numpy().T)).T
    elif bad == "shape":
        coeff[1] = coeff[1][:-4].contiguous()
    elif bad == "bit depth":
        bds = [8, 7, 7]
    elif bad == "width":
        coeff[1], planes[1] = coeff[1][:, :-2].contiguous(), \
            planes[1][:, :-2].contiguous()
    else:
        x, y = int(row[0]), int(row[1])
        c, lg, md = tu_fields(int(row[TU_KIND]))
        qp = int(row[2])
        if bad == "mode":
            md = 3
        elif bad == "size":
            lg = 6
        elif bad == "component":
            c = 3
        elif bad == "outside":
            x = planes[c].shape[1] - (1 << lg) + 4
        elif bad == "negative":
            y = -4
        elif bad == "misaligned":
            x += 2
        elif bad == "qp":
            qp = 52
        table[0] = (x, y, qp, tu_kind(c, lg, md))
    return coeff, planes, table, bds


@pytest.mark.parametrize("bad", [
    "plane dtype", "table dtype", "table type", "table shape", "device",
    "unsupported device", "contiguous", "shape", "bit depth", "mode", "size",
    "component", "outside", "negative", "misaligned", "width", "qp"])
def test_dequant_idct_add_rejects_bad_inputs(bad):
    """(e), for the wrapper and its plain version."""
    args = _bad_inputs(bad)
    fns = [ttransform.dequant_idct_add]
    if bad != "unsupported device":  # the plain version runs on any device
        fns.append(ttransform.dequant_idct_add_ref)
    for fn in fns:
        with pytest.raises((TypeError, ValueError)):
            fn(*args)


def test_dequant_inverse_transform_raises_off_the_cpu():
    """The per-size entry has no kernel: off the CPU it raises and names the
    picture-level call."""
    lv = torch.zeros((2, 8, 8), dtype=torch.int32, device="meta")
    qp = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="dequant_idct_add"):
        ttransform.dequant_inverse_transform(lv, qp, 8, 3, 0)
