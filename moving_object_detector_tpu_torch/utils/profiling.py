"""Profiling (the JAX package's ``utils/profiling.py``): the port's span
recorder, per-stage wall-clock timers and a ``torch.profiler`` trace
around a region.

A span is a named interval of one unit of work (a stereo pair's index, a
train step) on the host's ``time.perf_counter_ns`` clock, with its parent
span. Span sites call ``span``, ``sync_point``, ``add``, ``count``,
``set_unit`` and ``StageTimer.stage``; they record into the recorder ``recording`` has made
active, and cost one check of a module flag when none is. Inside
``detect_step``, ``train_step`` and the trainer's batch, a span recorded
while a ``torch.profiler`` runs also opens a ``record_function`` range of
the same name, which puts the spans onto the device trace's clock
(``trace_offset_ns``).

The reference's chain-slope timer and its dead-code guard serve a
jit-compiled loop and have no counterpart here: PyTorch runs eagerly, and
a kernel is timed with CUDA events (``chip_smoke.py``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Iterator, NamedTuple

import numpy as np

SYNC_PREFIX = "sync."


class Span(NamedTuple):
    name: str
    start: int  # perf_counter_ns
    end: int
    parent: int  # index of the enclosing span, -1 for none
    unit: int  # pair index or train step, -1 for none
    annotated: bool  # a record_function range of the same name was open


class _Off:
    """What a span site gets while no recorder is active."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_active: "SpanRecorder | None" = None
_ranges_warm = False


def _warm_ranges() -> None:
    """Open and close one range the first time a process opens one under
    a profiler: the first pays about a millisecond of set-up, which would
    put that span's range far from the span."""
    global _ranges_warm
    if not _ranges_warm:
        import torch

        _ranges_warm = True
        with torch.profiler.record_function("profiling.warm_up"):
            pass


class _Open:
    """One span being recorded."""

    __slots__ = ("rec", "name", "unit", "annotate", "sync", "index", "rf",
                 "mode")

    def __init__(self, rec, name, unit, annotate, sync):
        self.rec, self.name, self.unit = rec, name, unit
        self.annotate, self.sync = annotate, sync
        self.rf = None
        self.mode = 0

    def __enter__(self):
        rec = self.rec
        if self.sync:
            rec.count("syncs", unit=self.unit)
            import torch

            # Inside the helper the wait is named: a card-wide sync check
            # (torch.cuda.set_sync_debug_mode) is lifted for its length.
            if torch.cuda.is_initialized():
                self.mode = torch.cuda.get_sync_debug_mode()
                if self.mode:
                    torch.cuda.set_sync_debug_mode(0)
        elif rec.synchronize is not None:
            rec.synchronize()
        if self.annotate:
            import torch

            # The range is open for the whole span: it opens before the
            # span's first clock read and closes before its last.
            if torch._C._autograd._profiler_enabled():
                _warm_ranges()
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
        self.index = rec._open(self.name, self.unit)
        if self.rf is not None and self.index >= 0:
            rec._annotated[self.index] = True
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if not self.sync and rec.synchronize is not None:
            rec.synchronize()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec._close(self.index)
        if self.mode:
            import torch

            torch.cuda.set_sync_debug_mode(self.mode)
        return False


class SpanRecorder:
    """Spans and counters of units of work, kept in preallocated arrays
    until asked for (``spans``, ``counters``). Beyond ``capacity`` spans
    the rest are counted in ``lost`` and not kept. Records from one
    thread: spans nest by the order they open and close.

    ``synchronize``, a device, makes every span that is not a sync site
    synchronize the card as it opens and as it closes, so its length is
    the device time of its work too: ``chip_smoke.py``'s per-stage
    milliseconds. It changes what it measures; leave it None elsewhere.
    """

    def __init__(self, capacity: int = 1 << 18, synchronize=None):
        self.capacity = capacity
        self._name = np.zeros(capacity, np.int32)
        self._start = np.zeros(capacity, np.int64)
        self._end = np.zeros(capacity, np.int64)
        self._parent = np.zeros(capacity, np.int32)
        self._unit = np.zeros(capacity, np.int64)
        self._annotated = np.zeros(capacity, bool)
        self._names: list[str] = []
        self._ids: dict[str, int] = {}
        self._stack: list[int] = []
        self.n = 0
        self.lost = 0
        self.unit = -1
        self.counters: collections.Counter = collections.Counter()
        self.synchronize = None
        if synchronize is not None:
            import torch

            dev = torch.device(synchronize)
            if dev.type == "cuda":
                self.synchronize = lambda: torch.cuda.synchronize(dev)

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self._names)
            self._names.append(name)
        return i

    def _open(self, name: str, unit) -> int:
        t = time.perf_counter_ns()
        i = self.n
        if i >= self.capacity:
            self.lost += 1
            self._stack.append(-1)
            return -1
        self.n = i + 1
        self._name[i] = self._id(name)
        self._start[i] = t
        self._end[i] = t
        self._parent[i] = self._stack[-1] if self._stack else -1
        self._unit[i] = self.unit if unit is None else unit
        self._annotated[i] = False
        self._stack.append(i)
        return i

    def _close(self, i: int) -> None:
        t = time.perf_counter_ns()
        self._stack.pop()
        if i >= 0:
            self._end[i] = t

    def span(self, name: str, unit=None, annotate: bool = True,
             sync: bool = False) -> _Open:
        return _Open(self, name, unit, annotate, sync)

    def add(self, name: str, start_ns: int, end_ns: int | None = None,
            unit=None) -> None:
        """A span of known start (and end: now by default) that opened no
        range, outside any other."""
        end_ns = time.perf_counter_ns() if end_ns is None else end_ns
        i = self.n
        if i >= self.capacity:
            self.lost += 1
            return
        self.n = i + 1
        self._name[i] = self._id(name)
        self._start[i], self._end[i] = start_ns, end_ns
        self._parent[i] = -1
        self._unit[i] = self.unit if unit is None else unit
        self._annotated[i] = False

    def count(self, name: str, n: int = 1, unit=None) -> None:
        self.counters[(name, self.unit if unit is None else unit)] += n

    def spans(self) -> list[Span]:
        names = self._names
        return [Span(names[k], int(a), int(b), int(p), int(u), bool(r))
                for k, a, b, p, u, r in zip(
                    self._name[:self.n].tolist(), self._start[:self.n],
                    self._end[:self.n], self._parent[:self.n],
                    self._unit[:self.n], self._annotated[:self.n])]

    def totals_ms(self) -> dict[str, float]:
        """Total ms of each span name."""
        out: dict[str, float] = defaultdict(float)
        for s in self.spans():
            out[s.name] += (s.end - s.start) / 1e6
        return dict(out)


@contextlib.contextmanager
def recording(recorder: SpanRecorder | None = None
              ) -> Iterator[SpanRecorder]:
    """Make ``recorder`` (a new one by default) the one span sites record
    into, for the length of the block."""
    global _active
    rec = SpanRecorder() if recorder is None else recorder
    prev, _active = _active, rec
    try:
        yield rec
    finally:
        _active = prev


def active() -> SpanRecorder | None:
    return _active


def span(name: str, unit=None):
    """A span site: ``with span("sgm"): ...``."""
    rec = _active
    return _OFF if rec is None else rec.span(name, unit)


def sync_point(site: str):
    """The one helper around a call that makes the host wait for the card
    (``.tolist()``, ``bool()`` / ``int()`` of a device tensor, a pageable
    copy to or from it): span ``sync.<site>``, one more ``syncs`` in the
    unit's counter. Keep one statement inside."""
    rec = _active
    return _OFF if rec is None else rec.span(SYNC_PREFIX + site, sync=True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the current unit, if a recorder is
    active."""
    rec = _active
    if rec is not None:
        rec.count(name, n)


def set_unit(unit: int) -> None:
    """The unit of work later spans belong to, unless they name one."""
    rec = _active
    if rec is not None:
        rec.unit = int(unit)


def clock_ns() -> int:
    """The spans' clock while a recorder is active, else 0 (no read)."""
    return 0 if _active is None else time.perf_counter_ns()


def add(name: str, start_ns: int | None, unit=None) -> None:
    """A span from ``start_ns`` to now, if a recorder is active and the
    start is known."""
    rec = _active
    if rec is not None and start_ns:
        rec.add(name, start_ns, unit=unit)


class StageTimer:
    """Accumulates wall-clock samples per named stage; each stage is also
    a span (``unit``: the recorder's current one by default) while a
    recorder is active. It opens no profiler range: the runner's stages
    cross the profiler's start and stop.

    Usage::

        timer = StageTimer()
        with timer.stage("sgm"):
            ... # host-side section; device work must be blocked on
        print(timer.report())
    """

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, unit=None) -> Iterator[None]:
        rec = _active
        sp = None if rec is None else rec.span(name, unit, annotate=False)
        if sp is not None:
            sp.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)
            if sp is not None:
                sp.__exit__(None, None, None)

    def add(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, vals in self.samples.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<20} {'n':>5} {'mean':>8} {'p50':>8} {'p95':>8}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<20} {s['count']:>5} {s['mean_ms']:>7.2f}ms "
                f"{s['p50_ms']:>7.2f}ms {s['p95_ms']:>7.2f}ms"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Reading the spans
# ---------------------------------------------------------------------------


def per_unit_ms(spans, name: str, self_time: bool = False) -> dict:
    """{unit: ms} of the spans named ``name``; with ``self_time``, less
    their ``sync.*`` children."""
    out: dict[int, float] = defaultdict(float)
    idx = [i for i, s in enumerate(spans) if s.name == name]
    for i in idx:
        out[spans[i].unit] += (spans[i].end - spans[i].start) / 1e6
    if self_time:
        mine = set(idx)
        for s in spans:
            if s.parent in mine and s.name.startswith(SYNC_PREFIX):
                out[s.unit] -= (s.end - s.start) / 1e6
    return dict(out)


def sync_ms(spans) -> dict:
    """{unit: ms} of a unit's ``sync.*`` spans together."""
    out: dict[int, float] = defaultdict(float)
    for s in spans:
        if s.name.startswith(SYNC_PREFIX):
            out[s.unit] += (s.end - s.start) / 1e6
    return dict(out)


def unit_counts(counters, name: str) -> dict:
    """{unit: n} of counter ``name``."""
    return {u: n for (k, u), n in counters.items() if k == name}


def report(recorder: SpanRecorder, trace: dict | None = None) -> str:
    """One row a span name: the units it ran in, its mean ms a unit (self
    ms, its ``sync.*`` children taken out, beside it) and calls a unit;
    with ``trace``, a profiler's Chrome trace of the same run, the device
    ms a unit of the operations launched inside it and, last, the device's
    idle seconds by span. Then the counters' means a unit."""
    spans = recorder.spans()
    dev, idle = {}, {}
    off = None if trace is None else trace_offset_ns(spans, trace)
    if off is not None:
        dev = device_ms_by_span(spans, trace, off)
        idle = idle_by_span(spans, trace, off)
    by = collections.Counter(s.name for s in spans)
    lines = [f"{'span':<34} {'units':>6} {'ms/unit':>9} {'self':>9} "
             f"{'n/unit':>7}" + (f" {'device':>9}" if dev else "")]
    for name in sorted(by):
        tot = per_unit_ms(spans, name)
        own = per_unit_ms(spans, name, self_time=True)
        row = (f"{name:<34} {len(tot):>6} "
               f"{statistics.fmean(tot.values()):>8.3f}  "
               f"{statistics.fmean(own.values()):>8.3f}  "
               f"{by[name] / len(tot):>6.2f}")
        if dev:
            row += f" {sum(dev.get((name, u), 0.0) for u in tot) / len(tot):>9.3f}"
        lines.append(row)
    for name in sorted({k for k, _ in recorder.counters}):
        vals = unit_counts(recorder.counters, name)
        lines.append(f"{'counter ' + name:<34} {len(vals):>6} "
                     f"{statistics.fmean(vals.values()):>9.3f}")
    if idle:
        lines.append("device idle s by span: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(idle.items(),
                                              key=lambda kv: -kv[1])))
    if recorder.lost:
        lines.append(f"spans not kept (buffer full): {recorder.lost}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The spans on a profiler's clock (its Chrome trace)
# ---------------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_offset_ns(spans, trace: dict) -> int | None:
    """The offset to add to a span's clock to land on ``trace``'s (a
    Chrome trace as ``torch.profiler`` exports it): the median over the
    spans that opened a ``record_function`` range of the range's start
    less the span's, the k-th span of a name matched with the k-th range
    of that name. None where no span opened a range."""
    ranges = defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges[e["name"]].append(float(e["ts"]) * 1e3)
    mine = defaultdict(list)
    for s in spans:
        if s.annotated:
            mine[s.name].append(s.start)
    diffs = []
    for name, starts in mine.items():
        for a, b in zip(sorted(starts), sorted(ranges.get(name, ()))):
            diffs.append(b - a)
    return int(round(statistics.median(diffs))) if diffs else None


def _device_ops(trace: dict):
    """(launches {correlation: host ts ns}, device ops [(start ns, end ns,
    correlation)]) of a Chrome trace."""
    launches, ops = {}, []
    for e in trace["traceEvents"]:
        cat = e.get("cat") or ""
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if cat.startswith("cuda_") and corr is not None:  # a launch call
            launches[corr] = float(e["ts"]) * 1e3
        elif cat in _DEVICE_CATS:
            a = float(e["ts"]) * 1e3
            ops.append((a, a + float(e.get("dur", 0.0)) * 1e3, corr))
    return launches, ops


def device_ms_by_span(spans, trace: dict, offset_ns: int) -> dict:
    """{(name, unit): device ms} of the device operations launched inside
    each span, a launch found by its correlation id and placed by the
    host time of its launch call (its kernel's name plays no part)."""
    launches, ops = _device_ops(trace)
    placed = sorted((launches[c], b - a) for a, b, c in ops
                    if c in launches)
    times = [t for t, _ in placed]
    out: dict = defaultdict(float)
    for s in spans:
        lo = bisect.bisect_left(times, s.start + offset_ns)
        hi = bisect.bisect_right(times, s.end + offset_ns)
        if hi > lo:
            out[(s.name, s.unit)] += sum(d for _, d in placed[lo:hi]) / 1e6
    return dict(out)


def idle_by_span(spans, trace: dict, offset_ns: int) -> dict:
    """{span name: seconds} of the trace's device idle time (the gaps
    between its device operations, from its first to its last) by the
    innermost span around each gap's midpoint: the most deeply nested,
    of those the last begun; "no span" where none is."""
    _, ops = _device_ops(trace)
    if not ops:
        return {}
    depth = []
    for s in spans:
        depth.append(0 if s.parent < 0 else depth[s.parent] + 1)
    ops.sort()
    t0, t1 = ops[0][0], max(b for _, b, _ in ops)
    near = [(d, s.start + offset_ns, s.end + offset_ns, s.name)
            for d, s in zip(depth, spans)
            if s.start + offset_ns <= t1 and s.end + offset_ns >= t0]
    out: dict = defaultdict(float)
    end = None
    for a, b, _ in ops:
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            around = [(d, x, name) for d, x, y, name in near
                      if x <= mid <= y]
            out[max(around)[2] if around else "no span"] += (a - end) / 1e9
        end = b if end is None else max(end, b)
    return dict(out)


def add_spans_to_trace(path: str, spans) -> None:
    """Write the spans into the Chrome trace at ``path`` as a track of
    their own, on its clock (``trace_offset_ns``); nothing where no span
    opened a range."""
    with open(path) as f:
        trace = json.load(f)
    off = trace_offset_ns(spans, trace)
    if off is None:
        return
    trace["traceEvents"] += [
        {"ph": "X", "cat": "span", "name": s.name, "pid": "spans",
         "tid": "spans", "ts": (s.start + off) / 1e3,
         "dur": (s.end - s.start) / 1e3, "args": {"unit": s.unit}}
        for s in spans]
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace_context(log_dir: str | None) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` trace when ``log_dir`` is
    given (host activity, and the card's when there is one); the Chrome
    trace goes to ``<log_dir>/trace.json``, with the spans of the
    recorder that is active at the region's end on a track of their own.
    A no-op otherwise."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if _active is not None:
        add_spans_to_trace(path, _active.spans())
