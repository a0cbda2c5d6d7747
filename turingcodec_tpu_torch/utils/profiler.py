"""Lightweight stage profiler (turing/Profiler.h:33-126 analogue).

Fixed timer tree reported as seconds and as time-per-sample, enabled by the
--profiler CLI flag. Thread-free (the pipeline is host-sequential; device
time is captured by block_until_ready at stage boundaries).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Profiler:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.enabled = False

    @contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, samples: int = 0) -> str:
        lines = ["profiler report:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            line = f"  {name:<24} {t:9.3f}s  x{self.counts[name]}"
            if samples:
                line += f"  {t / samples * 1e9:9.2f} ns/sample"
            lines.append(line)
        return "\n".join(lines)


PROFILER = Profiler()
