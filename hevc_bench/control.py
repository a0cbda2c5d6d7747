"""The controls of each kind of cell: runs with the timed path computed
one step below the configuration's precision, which its checks must
refuse.

- Encode cells, `seven_bit`: every plane the analysis stage sends to the
  device loses its lowest bit (device_analysis.upload), so the seed and
  dense fields, the SAD surface, the subpel planes and the rank tables
  are those of 7-bit pictures; the encoder codes with them, and
  analysis_mismatch compares them with the 8-bit reference.
- Encode cells, `coarser_qp`: the encoder quantises one bit coarser than
  the configuration states (QP + 6 doubles the quantiser's step), and
  distortion_db compares its reconstructions with the sources.
- Decode cells, `seven_bit`: every picture the device pipeline brings
  back to the host loses its lowest bit (device_pipeline._pull), so the
  output and the reference pictures are 7-bit; recon_mismatch and
  picture_mismatch compare them with the plain stages and the stream's
  own pictures.

    python3 -m hevc_bench.control --workload <name> --seeds 1,2,3
        [--seconds S] [--controls seven_bit,coarser_qp]

runs each seed under each control in this process, on the card, at the
cell's own size, and prints each run's result line. The benchmark's own
runs never run it; hevc_bench/tests/test_bench_faults.py runs it on the
CPU at a small size.
"""
from __future__ import annotations

import os

for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from hevc_bench import harness  # noqa: E402


def seven_bit_upload(orig):
    def upload(plane, device, *a, **k):
        return orig(np.asarray(plane) & ~1, device, *a, **k)
    return upload


def seven_bit_pull(orig):
    def pull(planes):
        return [p & ~1 for p in orig(planes)]
    return pull


def coarser_qp(orig):
    def config(run):
        cfg = orig(run)
        cfg.qp += 6
        return cfg
    return config


CONTROLS = {
    "enc": {"seven_bit": [(("turingcodec_tpu_torch.encode.device_analysis",
                            "upload"), seven_bit_upload)],
            "coarser_qp": [(("hevc_bench.drivers.enc", "encoder_config"),
                            coarser_qp)]},
    "dec": {"seven_bit": [(("turingcodec_tpu_torch.decode.device_pipeline",
                            "_pull"), seven_bit_pull)]},
}


def run_control(workload, seed, seconds, device="cuda", config=None,
                spec=None, control="seven_bit"):
    """One run of the cell under one of its controls: (result, checks)."""
    with harness.patched(CONTROLS[workload.split("-")[0]][control]):
        result, _info, lines = harness.execute(
            workload, seed, seconds, False, device, spec, config=config)
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--controls")
    a = ap.parse_args(argv)
    spec = harness.load_spec()
    seconds = a.seconds or spec["run_seconds"]
    kinds = CONTROLS[a.workload.split("-")[0]]
    names = a.controls.split(",") if a.controls else list(kinds)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from hevc_bench.run import build
    build(harness.driver_for(a.workload).BUILD)
    for seed in [int(s) for s in a.seeds.split(",")]:
        for name in names:
            result, lines = run_control(a.workload, seed, seconds, "cuda",
                                        spec=spec, control=name)
            print(json.dumps({"control": name, "workload": a.workload,
                              "seed": seed, "correct": result["correct"],
                              "checks": result["checks"],
                              "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
