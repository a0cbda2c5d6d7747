"""Runs of the benchmark in a row, each its own process, as the bounds are
measured: the result lines go to a JSON-lines file and a summary to
standard output.

    python3 -m hevc_bench.series --workload <name> --seeds 1,2,3
        [--seconds S] [--trace 0|1] [--out FILE]

--seconds defaults to BENCHMARK.json's run_seconds. Each record holds the
seed, the exit code, the wall time, the result line and the end of
standard error. Then, for each metric, the quartile spread of the runs
(the distance between the first and the third quartile of
statistics.quantiles, over the median).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from hevc_bench import harness


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    seconds = a.seconds or harness.load_spec()["run_seconds"]
    records = []
    for seed in [int(s) for s in a.seeds.split(",")]:
        cmd = [sys.executable, "-m", "hevc_bench.run", "--workload",
               a.workload, "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(a.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True,
                           cwd=harness.ROOT)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"workload": a.workload, "seed": seed, "seconds": seconds,
               "trace": a.trace, "rc": p.returncode, "wall_s": wall,
               "info": lines[:-1], "result": result,
               "stderr_tail": p.stderr[-3000:]}
        records.append(rec)
        summary = {k: v["value"] for k, v in
                   (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": p.returncode,
                          "wall_s": round(wall, 3),
                          "correct": (result or {}).get("correct"),
                          "metrics": summary,
                          "checks": (result or {}).get("checks")}),
              flush=True)
        if result is None:
            print(p.stderr[-3000:], flush=True)
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    ok = [r["result"] for r in records if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in ok if n in r["metrics"]]
        if len(vals) >= 2:
            print(f"{n}: median {statistics.median(vals)!r} spread "
                  f"{spread(vals)!r} over {len(vals)} runs", flush=True)
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
