"""Run one cell of the benchmark once, in this process, on this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (loading, building the kernels,
rendering the traffic, warming up), then a window of ``--seconds``, then
the check of the window's outputs against the plain reference
(``portbench/reference/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; then ``checks``,
each compared number beside its limit, as the last lines of standard
error too. Without a CUDA card, or with fewer than the cell asks for, it
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Build and kernel caches at fixed paths inside the checkout; libraries
# that could load JAX by themselves are told not to.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".portbench_cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".portbench_cache",
                                              "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# One process with few threads: the host's thread pools neither spin
# against the runner's threads nor wake up on every host copy.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

from portbench.core import bench  # noqa: E402


class Context:
    """What a driver is given: the cell, its configuration and traffic,
    the seed, the window, the device; ``setup_done`` marks the end of
    set-up."""

    def __init__(self, args, cell, config, traffic, device):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.device = device
        self.setup_s = None

    def setup_done(self):
        self.setup_s = time.perf_counter() - T_START


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = bench.benchmark()
    cell = bench.cell(spec, args.workload)
    device = bench.require_cuda(cell["chips"])
    config = bench.config_file(spec, cell["config"])
    traffic = bench.traffic_file(cell["traffic"])
    import importlib

    drv = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    import torch

    torch.set_num_threads(1)
    ctx = Context(args, cell, config, traffic, device)
    out = drv.run(ctx)
    card = bench.power_limit()
    bench.log(f"card: {card}; setup {ctx.setup_s!r} s; judged "
              f"{out['judged']}")

    metrics = {}
    if not args.trace:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in bench.metrics_of(spec, "end_to_end", cell["name"]):
            if m["name"] not in values:
                raise bench.BenchError(f"the run measured no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in bench.metrics_of(spec, "per_layer", cell["name"]):
            v = bench.metric_reader(m["name"]).read(out["view"], m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = out["view"].trace
        if tr:
            bench.log("traced part: " + str({k: tr[k] for k in (
                "units", "launches", "window_s", "host_wall_s", "busy_s",
                "other_device_ops", "start_s")}))
            bench.log("kernels in the traced part: " + str(tr["kernels"]))
            bench.log("longest idle gaps: " + str(tr["longest_gaps"]))
        bench.log(f"step_mfu's card: {card}")
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(out["memory_peak"])}
    result = {"correct": all(c["ok"] for c in out["checks"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    if args.trace:
        tr = out["view"].trace
        if not tr or not tr.get("launches"):
            raise bench.BenchError("the traced part recorded no device "
                                   "operation")
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    bench.finish(result, out["checks"])
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except bench.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        sys.exit(2)
