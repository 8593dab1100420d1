"""How the host ran around a window, read beside the metrics and never one
of them: what a run prints on standard error to tell a slow host from a
slow program.

Two speed readings, taken at the end of set-up and again after the
window: ``python_ms``, a fixed piece of pure Python work, and
``launch_us``, the host time a launch of one tiny in-place addition on
the device (synchronized once at the end). Over the window, from
``/proc/stat``: the cores this process kept busy, the cores the rest of
the machine kept busy, and the cores the hypervisor took away (steal).
"""

from __future__ import annotations

import os
import time

PY_LOOP = 300_000
LAUNCHES = 1000


def python_ms() -> float:
    """Milliseconds of a fixed loop of pure Python arithmetic."""
    t0 = time.perf_counter()
    s = 0
    for i in range(PY_LOOP):
        s += i * i % 7
    return 1e3 * (time.perf_counter() - t0)


def launch_us(device) -> float:
    """Host microseconds a launch of a one-element in-place addition."""
    import torch

    x = torch.zeros(1, device=device)
    x.add_(1.0)
    if x.is_cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        x.add_(1.0)
    if x.is_cuda:
        torch.cuda.synchronize(device)
    return 1e6 * (time.perf_counter() - t0) / LAUNCHES


def _proc_stat():
    """(busy, steal) CPU seconds of the whole machine, or None."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None
    hz = os.sysconf("SC_CLK_TCK")
    user, nice, system, idle, iowait, irq, softirq, steal = (v + [0] * 8)[:8]
    return (user + nice + system + irq + softirq) / hz, steal / hz


def _own_cpu() -> float:
    t = os.times()
    return t.user + t.system


def _mhz():
    try:
        with open("/proc/cpuinfo") as f:
            vals = [float(line.split(":")[1]) for line in f
                    if line.startswith("cpu MHz")]
        return round(sum(vals) / len(vals), 1) if vals else None
    except (OSError, ValueError):
        return None


class Probe:
    """``Probe(device)`` at the end of set-up, ``start()`` as the window
    opens, ``stop()`` once it has closed; ``summary()`` for the log."""

    def __init__(self, device):
        self.device = device
        self.before = dict(python_ms=python_ms(), launch_us=launch_us(device),
                           mhz=_mhz())
        self.after = None
        self.window = None

    def start(self):
        self._t0 = time.perf_counter()
        self._stat0 = _proc_stat()
        self._own0 = _own_cpu()

    def stop(self):
        wall = time.perf_counter() - self._t0
        own = _own_cpu() - self._own0
        stat = _proc_stat()
        w = dict(wall_s=wall, own_cores=own / wall)
        if stat and self._stat0:
            busy = stat[0] - self._stat0[0]
            w["others_cores"] = max(0.0, busy - own) / wall
            w["steal_cores"] = (stat[1] - self._stat0[1]) / wall
        self.window = w
        self.after = dict(python_ms=python_ms(),
                          launch_us=launch_us(self.device), mhz=_mhz())

    def summary(self) -> dict:
        aff = (sorted(os.sched_getaffinity(0))
               if hasattr(os, "sched_getaffinity") else None)
        return dict(before=self.before, window=self.window, after=self.after,
                    cpus=os.cpu_count(), affinity=aff,
                    loadavg=os.getloadavg() if hasattr(os, "getloadavg")
                    else None)
