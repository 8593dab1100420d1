"""The traced part of a run: a ``torch.profiler`` trace of a few pairs or
steps, the hand-written kernels' calls recorded beside it, and what the
per-layer readers take from them.

``Recorder.start`` and ``stop`` synchronize the card, so the part holds
whole units of work. While it runs, each kernel bound of ``bounds/``
records the bytes and operations of every call of its wrapper from the
call's shapes; a call is wrapped only in a traced run.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import time

from . import stats

# NVIDIA H100 SXM (the data sheet): the bounds' peaks. Shares are against
# these, the card's power limit beside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def bound_seconds(nbytes: float, ops: float):
    """(least seconds, "bytes" or "operations") of work moving ``nbytes``
    and doing ``ops`` f32 operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Recorder:
    """Profiles from ``start`` to ``stop`` and records the bounded
    kernels' calls in between."""

    def __init__(self, bounds, device):
        self.bounds = bounds
        self.device = device
        self.active = False
        self.calls = collections.defaultdict(list)  # bound name -> [(b, o)]
        self.prof = None
        self.wall = None
        self.units = 0
        self._originals = []
        self._warm_profiler()
        for b in bounds:
            mod_name, fn_name = b.TARGET.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            setattr(mod, fn_name, self._wrap(b, orig))
            self._originals.append((mod, fn_name, orig))

    def _warm_profiler(self):
        """Start and stop a profiler once, in set-up: the first start
        initializes the tracing library for seconds, which would stall the
        window."""
        import torch

        self.start()
        torch.ones(8, device=self.device).sum()
        self.stop(0)
        self.prof = None

    def _wrap(self, bound, orig):
        def recorded(*args, **kwargs):
            if self.active:
                self.calls[bound.NAME].append(bound.bytes_ops(*args, **kwargs))
            return orig(*args, **kwargs)
        return recorded

    def restore(self):
        for mod, name, orig in self._originals:
            setattr(mod, name, orig)
        self._originals = []

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .bench import sync

        sync(self.device)
        t0 = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.active = True
        self._t0 = time.perf_counter()
        self.start_s = self._t0 - t0

    def stop(self, units: int):
        from .bench import sync

        sync(self.device)
        self.wall = time.perf_counter() - self._t0
        self.active = False
        self.prof.stop()
        self.units = units


def host_op_at(cpu_sorted, cpu_starts, t: float, reach: int = 4096) -> str:
    """The innermost host operation running at ``t``: of those that
    began at or before it and end after it, the one that began last.
    ``cpu_sorted`` is sorted by start, ``cpu_starts`` its starts."""
    i = bisect.bisect_right(cpu_starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if cpu_sorted[j][2] >= t:
            return cpu_sorted[j][0]
    return "no host operation"


def summarize(rec: Recorder) -> dict:
    """What the readers take from a traced part: its device intervals and
    launches, busy and window seconds, the busiest device operations, the
    idle gaps by what the host was doing, and each bounded kernel's
    calls, device seconds and bound."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_ev, cpu_ev = [], []
    for e in rec.prof.events():
        span = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type != cuda:
            cpu_ev.append((e.name, *span))
        elif not getattr(e, "is_user_annotation", False):
            # A range a ``record_function`` draws on the device's timeline
            # (AdamW's step) spans operations and the gaps between them: no
            # operation of its own.
            dev_ev.append((e.name, *span))
    if not dev_ev:
        return {"units": rec.units, "launches": 0, "device_events": 0}
    starts = [a for _, a, _ in dev_ev + cpu_ev]
    ends = [b for _, _, b in dev_ev + cpu_ev]
    t0, t1 = min(starts), max(ends)
    intervals = [(a, b) for _, a, b in dev_ev]
    busy = stats.union_seconds(intervals)
    by_name = collections.Counter()
    for name, a, b in dev_ev:
        by_name[name] += b - a
    idle = collections.Counter()
    longest = []
    cpu_sorted = sorted(cpu_ev, key=lambda x: x[1])
    cpu_starts = [c[1] for c in cpu_sorted]
    for a, b in stats.gaps(intervals, t0, t1):
        name = host_op_at(cpu_sorted, cpu_starts, 0.5 * (a + b))
        idle[name] += b - a
        longest.append((b - a, name))
    kernels = []
    for bnd in rec.bounds:
        calls = rec.calls.get(bnd.NAME, [])
        matched = [(n, a, b) for n, a, b in dev_ev
                   if bnd.DEVICE_NAME.search(n)]
        if not calls and not matched:
            continue
        secs = [bound_seconds(nb, ops) for nb, ops in calls]
        by = collections.Counter(x for _, x in secs)
        kernels.append(dict(
            kernel=bnd.NAME, calls=len(calls), launches=len(matched),
            device_s=sum(b - a for _, a, b in matched),
            bound_s=sum(s for s, _ in secs),
            bound_by=by.most_common(1)[0][0] if by else None,
            bytes=sum(nb for nb, _ in calls),
            operations=sum(ops for _, ops in calls)))
    unmatched = collections.Counter()
    for n, a, b in dev_ev:
        if not any(bnd.DEVICE_NAME.search(n) for bnd in rec.bounds):
            unmatched[n] += b - a
    return {
        "units": rec.units,
        "start_s": rec.start_s,
        "launches": len(dev_ev),
        "window_s": t1 - t0,
        "host_wall_s": rec.wall,
        "busy_s": busy,
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in idle.most_common(10)],
        "longest_gaps": [[n, s] for s, n in sorted(longest,
                                                   reverse=True)[:10]],
        "kernels": kernels,
        "other_device_ops": len(unmatched),
    }
