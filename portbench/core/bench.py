"""What a run of the benchmark shares: its files found by name, the
device it runs on, the check that no JAX module was loaded, and the last
line it prints.

Every piece that belongs to one configuration, traffic mix, driver,
per-layer metric or kernel bound lives in a file of its own under
``portbench/`` and is found here by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: a traffic mix, whose ``driver`` key names
  the module ``portbench.drivers.<driver>`` that drives it;
* ``metrics/<metric>.py``, else ``metrics/<name before the first dot>.py``:
  a per-layer metric's reader, ``read(run) -> float | None``;
* ``bounds/*.py``: one kernel's bytes and operations from its call shapes.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from. Compared whole: the port's own name
# begins with the JAX package's.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax",
                               "moving_object_detector_tpu"})


class BenchError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise BenchError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    path = os.path.join(BENCH_DIR, "traffic", name + ".json")
    if not os.path.exists(path):
        raise BenchError(f"no traffic mix {path}")
    return load_json(path)


def load_module(path: str, name: str):
    """A module of ``portbench/`` loaded from its file (names may hold
    dots, which ``import`` cannot take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py`` or,
    failing that, the reader of its quantity, ``metrics/<quantity>.py``
    for ``<quantity>.<suffix>``."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(BENCH_DIR, "metrics", stem + ".py")
        if os.path.exists(path):
            return load_module(path, "portbench_metric_" +
                               stem.replace(".", "_"))
    raise BenchError(f"no reader for per-layer metric {name!r}")


def bound_modules() -> list:
    """Every kernel bound of ``bounds/``, sorted by file name."""
    return [load_module(p, "portbench_bound_" +
                        os.path.basename(p)[:-3].replace(".", "_"))
            for p in sorted(glob.glob(os.path.join(BENCH_DIR, "bounds",
                                                   "*.py")))]


def metrics_of(bench: dict, key: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this workload reports."""
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def require_cuda(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise BenchError("CUDA is not available: no result")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    what it said instead."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            out.stderr.strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_loaded() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & FORBIDDEN_MODULES)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def finish(result: dict, checks: list) -> None:
    """Print the compared numbers beside their limits as the last lines
    of standard error, then the result as the last line of standard
    output, with the same numbers under its last key."""
    bad = forbidden_loaded()
    if bad:
        raise BenchError(f"modules loaded in the run that may not be: {bad}")
    for c in checks:
        log(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    """The most memory the process has held on the card since
    ``reset_peak``; 0 off the card."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def build_kernels(device) -> None:
    """Build the port's kernels up front, all at once (a checkout's first
    run), or load them; nothing to do off the card."""
    import torch

    if torch.device(device).type == "cuda":
        from moving_object_detector_tpu_torch import _build

        _build.build_all()
