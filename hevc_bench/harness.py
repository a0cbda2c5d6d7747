"""What every cell shares: the benchmark file, the import guard, spans,
the recording of kernel calls, the profiler's trace and the result line.

A cell's driver is hevc_bench/drivers/<kind>.py, <kind> the part of the
workload's name before its first '-' (enc, dec); a per-layer metric's
reader is hevc_bench/metrics/<metric>.py; a kernel's bound is
hevc_bench/bounds/<kernel>.py. Each is found by its name.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that no run may load: the JAX package and JAX
GUARDED = ("jax", "jaxlib", "flax", "turingcodec_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is guarded."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in GUARDED)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def cell_inputs(spec: dict, workload: str):
    """(cell, config, traffic) of a workload of BENCHMARK.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(conf["file"])
    traffic = load_json(os.path.join("hevc_bench", "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def driver_for(workload: str):
    return importlib.import_module(
        "hevc_bench.drivers." + workload.split("-")[0])


def metric_reader(name: str):
    """The read(run) function of hevc_bench/metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "hevc_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def bounds_module(kernel: str):
    return importlib.import_module("hevc_bench.bounds." + kernel)


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of this cell reports: with trace 1 the
    per-layer metrics whose `workloads` list it; with trace 0 the
    end-to-end metrics whose `workloads` list it, and those with no list,
    which every cell reports. Raises ValueError where the cell is given an
    end-to-end metric other than setup_s that its driver does not declare
    in END_TO_END, which no run of it could report."""
    if trace:
        return [m for m in spec["per_layer"] if workload in m["workloads"]]
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    declared = set(driver_for(workload).END_TO_END) | {"setup_s"}
    unmeasured = [m["name"] for m in e2e if m["name"] not in declared]
    if unmeasured:
        raise ValueError(f"{workload}: its driver measures none of "
                         f"{unmeasured}")
    return e2e


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100), linear between closest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    end = -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class Run:
    """One run's state: its inputs, spans and counters, what the timed path
    produced for the checks, and the profiled part's readings."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.spans = {}          # name -> [seconds, ...]
        self.kernel_calls = []   # (bounds module, args, kwargs)
        self.profile = None      # readings of the profiled part
        self.info = []           # lines printed before the result
        self.checks = []         # (name, value, limit)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time a block on the host clock, the card synchronised at its end
        when `sync`; a profiler annotation of the same name."""
        import torch
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.spans.get(name, ()))


@contextlib.contextmanager
def patched(pairs):
    """Replace module attributes for the block: pairs of ((module name,
    attribute), factory), factory(original) -> replacement."""
    saved = []
    try:
        for (mod, attr), factory in pairs:
            m = importlib.import_module(mod)
            orig = getattr(m, attr)
            saved.append((m, attr, orig))
            setattr(m, attr, factory(orig))
        yield
    finally:
        for m, attr, orig in reversed(saved):
            setattr(m, attr, orig)


def recording(run: Run, kernels):
    """patched() pairs that record every call of the kernels' wrappers
    (bounds/<kernel>.py CALLS) with its arguments into run.kernel_calls."""
    pairs = []
    for k in kernels:
        bm = bounds_module(k)
        for target in bm.CALLS:
            def factory(orig, bm=bm):
                def rec(*args, **kwargs):
                    run.kernel_calls.append((bm, args, kwargs))
                    return orig(*args, **kwargs)
                return rec
            pairs.append((target, factory))
    return pairs


def profiled(run: Run, body, kernels):
    """Run body() under torch.profiler with the kernels' calls recorded,
    and keep in run.profile the device's busy seconds, the window's
    length, each kernel's device seconds and launches, each kernel's bound
    seconds, the device operations that took most time and the idle time
    by the innermost annotation the host was in."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(run.device)
    run.kernel_calls = []
    with patched(recording(run, kernels)):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.window"):
                body()
                if run.device.type == "cuda":
                    torch.cuda.synchronize(run.device)
            window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    run.profile = read_trace(events, window_s)
    bounds = {}
    for bm, args, kwargs in run.kernel_calls:
        s, _side = bm.bound(args, kwargs)
        bounds[bm.KERNEL] = bounds.get(bm.KERNEL, 0.0) + s
    run.profile["bound_s"] = bounds
    run.kernel_calls = []


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(events, window_s: float) -> dict:
    """The readings of a Chrome trace of the profiled part (times in us)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    notes = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(("bench.", "enc.",
                                                    "dec."))]
    ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in dev)
    busy = union_seconds(ivs) / 1e6
    by_name = {}
    for e in dev:
        n = str(e["name"])
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + float(e["dur"]) / 1e6, c + 1)
    ops = sorted(((n[:96], t) for n, (t, _c) in by_name.items()),
                 key=lambda x: -x[1])[:10]
    win = [e for e in notes if e["name"] == "bench.window"]
    gaps = {}
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        cur = w0
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in notes]
        edges = sorted({x for sp in spans for x in sp[:2]})
        for s, e in ivs + [(w1, w1)]:
            end = min(s, w1)
            if end > cur:
                # a gap in pieces at the annotations' edges, each piece
                # named by the innermost annotation around it
                cuts = [cur] + [x for x in edges if cur < x < end] + [end]
                for a, b in zip(cuts, cuts[1:]):
                    mid = (a + b) / 2
                    inner = [x for x in spans if x[0] <= mid <= x[1]]
                    label = min(inner, key=lambda x: x[1] - x[0])[2] \
                        if inner else "outside"
                    gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
            cur = max(cur, e)
            if cur >= w1:
                break
    return {"busy_s": busy, "window_s": window_s, "kernels": by_name,
            "device_ops": [[n, t] for n, t in ops],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda x: -x[1])[:10]}


def kernel_seconds(run: Run, kernel: str):
    """(device seconds, launches) of a kernel in the profiled part."""
    t = c = 0
    for name, (s, n) in run.profile["kernels"].items():
        if kernel in name:
            t += s
            c += n
    return t, c


def roofline_share(run: Run, kernels) -> "float | None":
    """The kernels' summed bounds over their summed device time, in %, or
    None where the profiled part ran none of them."""
    if not run.profile:
        return None
    dev = bound = 0.0
    for k in kernels:
        kname = bounds_module(k).KERNEL
        t, _n = kernel_seconds(run, kname)
        dev += t
        bound += run.profile["bound_s"].get(kname, 0.0)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev


def idle_share(run: Run) -> "float | None":
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernel_lines(run: Run, kernels) -> dict:
    """Per kernel: device seconds, launches, bound seconds and share."""
    out = {}
    for k in kernels:
        kname = bounds_module(k).KERNEL
        t, n = kernel_seconds(run, kname)
        b = run.profile["bound_s"].get(kname, 0.0)
        out[k] = {"device_s": t, "launches": n, "bound_s": b,
                  "share_pct": 100.0 * b / t if t > 0 else None}
    return out


def device_block(run: Run, memory_peak: int) -> dict:
    import torch
    d = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
         "kind": (torch.cuda.get_device_name(run.device)
                  if run.device.type == "cuda" else "cpu"),
         "count": 1, "memory_peak_bytes": int(memory_peak)}
    if run.trace and run.profile:
        d["busy_s"] = run.profile["busy_s"]
        d["window_s"] = run.profile["window_s"]
    return d


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", spec=None, config=None, t_start=None,
            stage_seconds: float = 8.0):
    """One run of a cell; returns (result dict, check lines). `config`
    replaces the cell's configuration (the tests run small pictures on the
    CPU). `stage_seconds` caps the traced run's profiled part."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec() if spec is None else spec
    cell, conf, traffic = cell_inputs(spec, workload)
    wanted = cell_metrics(spec, workload, trace)
    config = conf if config is None else config
    run = Run(cell, config, traffic, seed, seconds, trace,
              torch.device(device))
    drv = driver_for(workload)
    state = drv.setup(run)
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"loaded after set-up: {bad}")
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    setup_s = time.perf_counter() - t_start
    run.state = state
    drv.window(run, state, seconds, stage_trace=trace)
    if trace:
        profiled(run, lambda: drv.window(run, state, min(seconds,
                                                         stage_seconds),
                                         stage_trace=False, part="profile"),
                 drv.KERNELS)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"loaded by the window: {bad}")
    t_check = time.perf_counter()
    drv.release(run, state)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    drv.check(run, state)
    run.info.append(f"checks took {time.perf_counter() - t_check:.3f} s "
                    f"after a window of {seconds} s")
    metrics = {}
    for m in wanted:
        if not trace:
            v = setup_s if m["name"] == "setup_s" else drv.end_to_end(
                run, state, m["name"])
        else:
            v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and run.profile:
        run.info.append("kernels " + json.dumps(kernel_lines(run,
                                                            drv.KERNELS)))
    correct = all(v <= lim for _n, v, lim in run.checks)
    attempted, failed = drv.counts(run, state)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": device_block(run, peak)}
    if trace and run.profile:
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in run.checks}
    lines = [f"check {n} {v} limit {lim}" for n, v, lim in run.checks]
    return result, run.info, lines
