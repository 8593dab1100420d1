"""A cell shrunk to run on the CPU in seconds: the same drivers, judges
and reference, at 64 x 128 (serving) or 64 x 64 (training), for tests."""

from __future__ import annotations

import copy
import importlib
import time

import torch

from portbench.core import bench


class Ctx:
    """The driver's context (``portbench/run.py``'s ``Context``)."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace):
        self.cell, self.config, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, bool(trace)
        self.device = torch.device("cpu")
        self.keep_records = True
        self._t0 = time.perf_counter()
        self.setup_s = None

    def setup_done(self):
        self.setup_s = time.perf_counter() - self._t0


def shrink(cell_name: str):
    """(cell, configuration, traffic) of a cell, shrunk."""
    spec = bench.benchmark()
    cell = bench.cell(spec, cell_name)
    cfg = copy.deepcopy(bench.config_file(spec, cell["config"]))
    tr = copy.deepcopy(bench.traffic_file(cell["traffic"]))
    if tr["driver"] == "stream":
        cfg.update(height=64, width=128)
        cfg["camera"]["fx"] = 74.0
        cfg["sgm"]["max_disparity"] = 32
        cfg["clusterer"].update(cluster_size=20, cc_crop_h=32, cc_crop_w=64)
        tr["scene_changes"] = dict(tr.get("scene_changes", {}), pairs=12,
                                   texture_hw=[40, 60])
        tr.update(warmup_pairs=3, check_pairs=2, trace_pairs=2)
        if tr["arrival"] == "open":
            tr["rate"] = 2.0
        else:
            tr["check_rate"] = 4.0
    else:
        cfg.update(height=64, width=64, batch=2, chunk=4)
        tr.update(trace_steps=2, judge_chunks=1)
    return cell, cfg, tr


def run(cell_name: str, seed: int = 12345678901, seconds: float = 3.0,
        trace: int = 0):
    """(context, the driver's result) of one shrunk run on the CPU."""
    torch.set_num_threads(4)
    cell, cfg, tr = shrink(cell_name)
    ctx = Ctx(cell, cfg, tr, seed, seconds, trace)
    drv = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    return ctx, drv.run(ctx)
