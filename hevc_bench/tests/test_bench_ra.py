"""CPU tests of the random-access encode cell, enc-ra1080-motion
(ra_fast_1080p_one_idr x motion: hierarchical-B GOP 8 with SAO,
frame-parallel batches of two), at a small size with the kernels' plain
versions: a sound run is correct, its controls are not, and a traced run
reads the cell's per-layer metrics, as the low-delay cell reads the
subpel install's. Run from the repository root:

    python -m pytest hevc_bench/tests
"""
from __future__ import annotations

import pytest

from hevc_bench import control, harness

RA, LDP = "enc-ra1080-motion", "enc-ldp1080-motion"
SEED = 2**33 + 41
# the window must reach past a mini-GOP's push, which codes 8 pictures
SECONDS = 4.0
# ra_fast_1080p_one_idr's QP offsets (+1 to +4 by temporal layer, +3.1 on
# average) put a sound run's distortion_db 2.1 dB above the low-delay
# cell's; the yardstick reads higher the smaller the picture (the
# low-delay cell: 0.37 to 0.53 dB at 1920x1080, 1.53 at 192x128), and
# at 192x128 a sound RA run reads 4.7 dB, over the limit of 3.5; at
# 384x256 it reads 2.6
WIDTH, HEIGHT = 384, 256
RA_METRICS = ("enc.bi_search_ms", "enc.sao_search_ms",
              "enc.batch_occupancy", "enc.subpel_install_mb")


def small(workload):
    cfg = harness.cell_inputs(harness.load_spec(), workload)[1]
    return dict(cfg, width=WIDTH, height=HEIGHT)


def test_sound_run_is_correct():
    result, info, _lines = harness.execute(RA, SEED, SECONDS, False, "cpu",
                                           config=small(RA))
    assert result["correct"], (result["checks"], info)
    assert set(result["metrics"]) == {"encode_fps", "setup_s"}
    assert all(v["value"] == 0 for n, v in result["checks"].items()
               if n != "distortion_db"), result["checks"]
    # the window codes whole mini-GOPs: 8 pictures a push that codes
    assert result["attempted"] % 8 == 0 and result["attempted"] >= 8


@pytest.mark.parametrize("name,fails", [
    ("seven_bit", "decode_mismatch"),
    ("coarser_qp", "distortion_db"),
])
def test_controls_fail(name, fails):
    res, _lines = control.run_control(RA, SEED, SECONDS, "cpu",
                                      config=small(RA), control=name)
    assert not res["correct"], res["checks"]
    c = res["checks"][fails]
    assert c["value"] > c["limit"], res["checks"]


def test_traced_runs_read_the_new_metrics():
    """The new cell's four metrics, and the low-delay cell's subpel
    install, from each cell's traced run."""
    for workload, names in ((RA, RA_METRICS),
                            (LDP, ("enc.subpel_install_mb",))):
        cfg = dict(small(workload), width=192, height=128)
        result, _info, _lines = harness.execute(
            workload, SEED, 2.0, True, "cpu", config=cfg, stage_seconds=2.0)
        for n in names:
            v = result["metrics"][n]["value"]
            assert isinstance(v, float) and v > 0, (workload, n, v)
        if workload == RA:
            assert result["metrics"]["enc.batch_occupancy"]["value"] <= 100
            # both lists' 15 planes of the reference padded by 28
            assert result["metrics"]["enc.subpel_install_mb"]["value"] == \
                pytest.approx(2 * 15 * (128 + 56) * (192 + 56) * 2 / 1e6,
                              rel=1e-12)
