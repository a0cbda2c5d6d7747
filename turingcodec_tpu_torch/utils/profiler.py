"""The port's trace: spans and counters inside the encoder and the decoder,
per picture (the reference's --profiler, turing/Profiler.h:33-126).

A span records its name, its start and end on time.perf_counter_ns (the
CLOCK_MONOTONIC clock the native core's now_ns reads), the span it ran
inside and the picture it belongs to. A picture is a root span:
``enc.docket`` (one coded picture, named (POC, input index)) or
``dec.finish`` (one decoded picture, named by its POC). Counters add up
per picture, at the same boundaries as the spans.

Recording is on while a torch.profiler session records, or while
``TRACE.forced`` is set (the tools' --profiler); it is decided once per
picture, at the root span, and recording that starts afresh clears the
records, so they hold the last recorded stretch. While the profiler
records, every span is also a ``torch.profiler.record_function``
annotation of its name: the device trace then names the host's work on
its own clock. Spans time what the host does and never synchronise the
device. With recording off a span site costs one flag check: no clock
read, no profiler call.

A picture's phases may run on several threads (frame-parallel encoding):
``root`` starts a picture's span without entering it, ``within(root)``
makes it the parent of the spans a thread opens, and ``root.end()`` ends
it. ``group`` starts a root span that is not a picture (``enc.batch``:
the pictures that encode together), with counters of its own.
"""
from __future__ import annotations

import itertools
import threading
import time


def _profiling() -> bool:
    import torch
    return bool(torch.autograd._profiler_enabled())


class _Off:
    """Every span, root and `within` block while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("trace", "name", "id", "parent", "root", "t0", "note")

    def __init__(self, trace, name, parent, root):
        self.trace, self.name = trace, name
        self.parent, self.root = parent, root
        self.id = next(trace._ids)
        self.note = None
        self.t0 = time.perf_counter_ns()
        if trace.annotate:
            import torch
            self.note = torch.profiler.record_function(name)
            self.note.__enter__()

    def __enter__(self):
        self.trace._stack().append(self)
        return self

    def __exit__(self, *exc):
        self.trace._stack().pop()
        self.end()
        return False

    def end(self):
        t1 = time.perf_counter_ns()
        if self.note is not None:
            self.note.__exit__(None, None, None)
        self.trace.spans.append((self.name, self.t0, t1, self.id,
                                 self.parent, self.root))


class _Within:
    __slots__ = ("trace", "span")

    def __init__(self, trace, span):
        self.trace, self.span = trace, span

    def __enter__(self):
        self.trace._stack().append(self.span)
        return self.span

    def __exit__(self, *exc):
        self.trace._stack().pop()
        return False


class Trace:
    def __init__(self):
        self.on = False          # recording now
        self.forced = False      # record without a profiler session
        self.annotate = False    # a profiler session records: annotate
        self.on_switch = None    # f(on) at each start and stop of recording
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.clear()

    def clear(self):
        # (name, start ns, end ns, id, parent id, root id) of ended spans
        self.spans = []
        self.pictures = {}       # root id -> picture
        self.counters = {}       # root id (None: outside any) -> {name: n}

    def _stack(self):
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def root(self, name: str, picture=None):
        """Start a picture's span (not entered: see `within`); decides
        whether this picture records."""
        annotate = _profiling()
        on = self.forced or annotate
        if on != self.on:
            if on:
                self.clear()
            self.on = on
            if self.on_switch is not None:
                self.on_switch(on)
        self.annotate = annotate
        if not on:
            return _OFF
        s = self._stack()
        span = _Span(self, name, s[-1].id if s else None, None)
        span.root = span.id
        self.pictures[span.id] = picture
        return span

    def group(self, name: str):
        """Start a root span that is no picture, with counters of its own
        (see `within`), while recording is on; it does not decide whether
        recording is on."""
        if not self.on:
            return _OFF
        span = _Span(self, name, None, None)
        span.root = span.id
        return span

    def within(self, root):
        """The block's spans and counters belong to `root`."""
        if not self.on or root is _OFF:
            return _OFF
        return _Within(self, root)

    def span(self, name: str):
        """A span of the block, inside the span the thread is in."""
        if not self.on:
            return _OFF
        s = self._stack()
        if s:
            return _Span(self, name, s[-1].id, s[-1].root)
        return _Span(self, name, None, None)

    def set_picture(self, picture):
        """Name the picture of the thread's root span (once known)."""
        if not self.on:
            return
        s = self._stack()
        if s:
            self.pictures[s[-1].root] = picture

    def count(self, name: str, n=1):
        """Add n to the counter of the thread's picture."""
        if not self.on:
            return
        s = self._stack()
        root = s[-1].root if s else None
        with self._lock:
            c = self.counters.setdefault(root, {})
            c[name] = c.get(name, 0) + n

    # ------------------------------------------------------------ reading
    def durations(self, name: str) -> dict:
        """root id -> summed ns of the spans of `name` in that picture."""
        out = {}
        for s in self.spans:
            if s[0] == name:
                out[s[5]] = out.get(s[5], 0) + s[2] - s[1]
        return out

    def counter(self, name: str) -> dict:
        """root id -> the counter's value in that picture."""
        return {r: c[name] for r, c in self.counters.items() if name in c}

    def summary(self) -> dict:
        """Per span name: count, total ns and self ns (each span's
        duration less the part of it its child spans cover); per counter:
        its total and its value per picture (over the pictures' root
        spans)."""
        kids = {}
        for s in self.spans:
            if s[4] is not None:
                kids.setdefault(s[4], []).append((s[1], s[2]))
        spans = {}
        for name, t0, t1, sid, _p, _r in self.spans:
            covered = 0
            end = t0
            for a, b in sorted(kids.get(sid, ())):
                a, b = max(a, end), min(b, t1)
                if b > a:
                    covered += b - a
                    end = b
            e = spans.setdefault(name, {"count": 0, "total_ns": 0,
                                        "self_ns": 0})
            e["count"] += 1
            e["total_ns"] += t1 - t0
            e["self_ns"] += t1 - t0 - covered
        roots = sum(1 for s in self.spans
                    if s[3] == s[5] and s[3] in self.pictures)
        counters = {}
        for c in self.counters.values():
            for k, v in c.items():
                counters[k] = counters.get(k, 0) + v
        return {"pictures": roots, "spans": spans, "counters": {
            k: {"total": v, "per_picture": v / roots if roots else None}
            for k, v in counters.items()}}

    def report(self) -> str:
        """The summary as text, spans by total time."""
        s = self.summary()
        n = s["pictures"]
        lines = [f"trace: {n} pictures, {len(self.spans)} spans",
                 f"  {'span':<18} {'count':>7} {'total ms':>11} "
                 f"{'self ms':>11} {'ms/picture':>11}"]
        for name, e in sorted(s["spans"].items(),
                              key=lambda kv: -kv[1]["total_ns"]):
            per = f"{e['total_ns'] / 1e6 / n:11.3f}" if n else f"{'':>11}"
            lines.append(f"  {name:<18} {e['count']:7d} "
                         f"{e['total_ns'] / 1e6:11.3f} "
                         f"{e['self_ns'] / 1e6:11.3f} {per}")
        for name, c in sorted(s["counters"].items()):
            per = "" if c["per_picture"] is None \
                else f"  ({c['per_picture']:.1f} a picture)"
            lines.append(f"  {name:<30} {c['total']}{per}")
        return "\n".join(lines)


TRACE = Trace()
