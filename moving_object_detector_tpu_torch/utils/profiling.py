"""Profiling (the JAX package's ``utils/profiling.py``): per-stage
wall-clock timers and a ``torch.profiler`` trace around a region.

The reference's chain-slope timer and its dead-code guard serve a
jit-compiled loop and have no counterpart here: PyTorch runs eagerly, and
a kernel is timed with CUDA events (``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage.

    Usage::

        timer = StageTimer()
        with timer.stage("sgm"):
            ... # host-side section; device work must be blocked on
        print(timer.report())
    """

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

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


@contextlib.contextmanager
def trace_context(log_dir: str | None) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` trace when ``log_dir`` is
    given (host activity, and the card's when there is one); the Chrome
    trace goes to ``<log_dir>/trace.json``. A no-op otherwise."""
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
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
