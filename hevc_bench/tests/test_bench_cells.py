"""CPU tests of which metrics a cell reports: each cell's end-to-end
metrics follow from BENCHMARK.json's lists and its driver's END_TO_END,
and a cell of an existing kind needs new entries only, as the
still-camera encode cell shows at a small size: correct, and its controls
not. Run from the repository root:

    python -m pytest hevc_bench/tests
"""
from __future__ import annotations

import copy
import os
from types import SimpleNamespace

import pytest

from hevc_bench import control, harness

SEED = 2**33 + 19
CELLS = {
    "enc-ldp1080-motion": {"encode_fps", "setup_s"},
    "dec-ra1080-motion": {"decode_fps", "decode_p95_ms", "setup_s"},
}
# cells made of existing files and new entries alone
NEW = {
    "enc-ldp1080-static": ("ldp_fast_1080p", "static",
                           {"encode_fps", "setup_s"}),
    "enc-ra1080-motion": ("ra_fast_1080p", "motion",
                          {"encode_fps", "setup_s"}),
    "dec-ra1080-static": ("ra_fast_1080p", "static",
                          {"decode_fps", "decode_p95_ms", "setup_s"}),
}


def drivers() -> dict:
    """Every kind of cell: its driver module by the kind's name."""
    folder = os.path.join(harness.BENCH, "drivers")
    kinds = sorted(f[:-3] for f in os.listdir(folder)
                   if f.endswith(".py") and not f.startswith("_"))
    return {k: harness.driver_for(k) for k in kinds}


def names(spec, workload, trace=False) -> set:
    return {m["name"] for m in harness.cell_metrics(spec, workload, trace)}


def with_cells(spec, cells):
    """A copy of the spec with each new cell's `workloads` entry and its
    name appended to the end-to-end lists of its kind's driver."""
    spec = copy.deepcopy(spec)
    for name in cells:
        config, traffic, _names = NEW[name]
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a test"})
        declared = harness.driver_for(name).END_TO_END
        for m in spec["end_to_end"]:
            if m["name"] in declared:
                m["workloads"].append(name)
    return spec


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_each_cell_reports_its_kinds_end_to_end_metrics(workload):
    assert names(harness.load_spec(), workload) == CELLS[workload]


def test_a_new_cell_of_each_kind_needs_new_entries_only():
    spec = harness.load_spec()
    grown = with_cells(spec, sorted(NEW))
    for w, (_config, _traffic, want) in NEW.items():
        assert names(grown, w) == want
        harness.cell_inputs(grown, w)
    for w in CELLS:
        assert names(grown, w) == CELLS[w]
        assert names(grown, w, True) == names(spec, w, True)
    # the old entries kept every key and value, and only grew their lists
    for part in ("configs", "end_to_end", "per_layer"):
        for old, now in zip(spec[part], grown[part]):
            assert {k: v for k, v in now.items() if k != "workloads"} == \
                {k: v for k, v in old.items() if k != "workloads"}
            assert now.get("workloads", [])[:len(old.get("workloads", []))] \
                == old.get("workloads", [])
    assert grown["workloads"][:len(spec["workloads"])] == spec["workloads"]


def test_a_cell_given_a_metric_its_driver_cannot_measure_is_refused():
    spec = with_cells(harness.load_spec(), ["dec-ra1080-static"])
    for m in spec["end_to_end"]:
        if m["name"] == "encode_fps":
            m["workloads"].append("dec-ra1080-static")
    with pytest.raises(ValueError, match="encode_fps"):
        harness.cell_metrics(spec, "dec-ra1080-static", False)
    # an end-to-end metric with no list is every cell's
    spec = harness.load_spec()
    spec["end_to_end"][0] = {k: v for k, v in spec["end_to_end"][0].items()
                             if k != "workloads"}
    with pytest.raises(ValueError):
        harness.cell_metrics(spec, "dec-ra1080-motion", False)


@pytest.mark.parametrize("kind", sorted(drivers()))
def test_a_driver_declares_what_it_measures(kind):
    drv = drivers()[kind]
    st = SimpleNamespace(n=12, elapsed=3.0, times=[0.05, 0.07, 0.06])
    asked = {m["name"] for m in harness.load_spec()["end_to_end"]}
    asked |= set(drv.END_TO_END) | {"frames_per_joule"}
    measured = {n for n in asked if drv.end_to_end(None, st, n) is not None}
    assert measured == set(drv.END_TO_END)
    assert len(drv.END_TO_END) == len(measured)


def test_every_end_to_end_metric_has_one_driver():
    spec = harness.load_spec()
    kinds = drivers()
    for m in spec["end_to_end"]:
        owners = [k for k, d in kinds.items() if m["name"] in d.END_TO_END]
        if m["name"] == "setup_s":
            assert not owners and "workloads" not in m
            continue
        assert len(owners) == 1, (m["name"], owners)
        for w in m.get("workloads", ()):
            assert w.split("-")[0] == owners[0], (m["name"], w)


def test_each_cell_reports_every_metric_its_driver_declares():
    """A cell left off its kind's lists would report setup_s alone."""
    spec = harness.load_spec()
    for w in spec["workloads"]:
        drv = harness.driver_for(w["name"])
        assert drv.END_TO_END, w["name"]
        assert names(spec, w["name"]) == set(drv.END_TO_END) | {"setup_s"}


STATIC = "enc-ldp1080-static"


def static_inputs():
    spec = with_cells(harness.load_spec(), [STATIC])
    cfg = harness.cell_inputs(spec, STATIC)[1]
    return spec, dict(cfg, width=128, height=64)


def test_static_sound_run_is_correct():
    spec, cfg = static_inputs()
    result, _info, _lines = harness.execute(
        STATIC, SEED, 1.5, False, "cpu", spec=spec, config=cfg)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == NEW[STATIC][2]
    assert all(v["value"] == 0 for n, v in result["checks"].items()
               if n != "distortion_db")


@pytest.mark.parametrize("name,fails", [
    ("seven_bit", "analysis_mismatch"),
    ("coarser_qp", "distortion_db"),
])
def test_static_controls_fail(name, fails):
    spec, cfg = static_inputs()
    res, _lines = control.run_control(STATIC, SEED, 1.5, "cpu", config=cfg,
                                      spec=spec, control=name)
    assert not res["correct"], res["checks"]
    c = res["checks"][fails]
    assert c["value"] > c["limit"], res["checks"]
