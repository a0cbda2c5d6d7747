"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 -m hevc_bench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout with an NVIDIA GPU. A run is one process: it
builds what is missing (the native core and the CUDA kernels, into the
checkout), makes its inputs from the seed, warms up, runs the measured
window, checks what the window produced against the plain reference in
hevc_bench/reference/, and prints one JSON line last on standard output;
the checked numbers beside their limits go last on standard error. It
exits 3 without printing a result where there is no usable card or a
guarded module (JAX, the JAX package) is loaded.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# BLAS worker threads spin after every numpy call and take cores from the
# codec's own threads (the port's package sets the same, but torch loads
# numpy and its BLAS before the package is first imported)
for _v in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from hevc_bench import harness  # noqa: E402

# every cache the program or its libraries write stays in the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(harness.ROOT, "build",
                                              "bench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(harness.ROOT, "build",
                                                  "bench_cache", "torch_ext")
os.environ["USE_FLAX"] = "0"
os.environ.pop("TURING_TPU_PIPELINE_TRACE", None)


def build(kernels) -> None:
    """The native host core and the cell's CUDA kernels, built together
    where missing or stale (the first run of a checkout)."""
    from concurrent.futures import ThreadPoolExecutor

    from turingcodec_tpu_torch import native
    from turingcodec_tpu_torch.ops import kernel_build
    jobs = [lambda k=k: kernel_build.build(k) for k in kernels]
    jobs.append(native.get_lib)
    with ThreadPoolExecutor(len(jobs)) as ex:
        for f in [ex.submit(j) for j in jobs]:
            f.result()
    if native.get_lib() is None:
        raise RuntimeError("the native host core did not build")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.cell_inputs(spec, a.workload)[0]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 3
    build(harness.driver_for(a.workload).BUILD)
    try:
        result, info, lines = harness.execute(
            a.workload, a.seed, a.seconds, bool(a.trace), "cuda", spec,
            t_start=T_START)
    except ImportError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: guarded modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in info:
        print(line)
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
