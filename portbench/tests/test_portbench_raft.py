"""The ``kitti_raft`` cell shrunk to run on the CPU: the RAFT driver,
its judge and the plain RAFT reference (``reference/raft.py``) at 128 x
128 with the published widths and 24 iterations. A sound run is correct;
a program one iteration short fails the flow's check; the control with
the all-pairs volume in bf16 fails by the lookup's number alone. The
CPU's backends take the card's semantics where the port's plain default
differs: the windowed gather of the scene flow (a random net's flow
reaches past the window) and the connected components run to their
fixpoint, as the card's union-find does."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from portbench import control_raft
from portbench.core import bench, judge_serve
from portbench.drivers import stream_raft
from portbench.tests import tiny


def _shrunk():
    spec = bench.benchmark()
    cell = bench.cell(spec, "kitti_raft.max_busy")
    cfg = copy.deepcopy(bench.config_file(spec, cell["config"]))
    tr = copy.deepcopy(bench.traffic_file(cell["traffic"]))
    cfg.update(height=128, width=128)
    cfg["camera"]["fx"] = 74.0
    cfg["sgm"]["max_disparity"] = 32
    cfg["clusterer"].update(cluster_size=20, cc_crop_h=32, cc_crop_w=64,
                            max_cc_iters=1 << 14)
    cfg["scene_flow"]["gather_backend"] = "pallas"
    tr["scene_changes"] = dict(pairs=12, texture_hw=[40, 60])
    tr.update(warmup_pairs=2, check_pairs=1, trace_pairs=2, check_rate=3.0)
    return cell, cfg, tr


def _run(monkeypatch, short=False):
    torch.set_num_threads(4)
    if short:
        real = stream_raft.program_net

        def one_short(cfg, device):
            model, net_cfg, state = real(cfg, device)
            model.config = dataclasses.replace(net_cfg,
                                               iters=net_cfg.iters - 1)
            return model, net_cfg, state

        monkeypatch.setattr(stream_raft, "program_net", one_short)
    cell, cfg, tr = _shrunk()
    ctx = tiny.Ctx(cell, cfg, tr, 31415926535, 2.0, 0)
    return ctx, cfg, stream_raft.run(ctx)


def _failed(checks) -> set:
    return {c["name"] for c in checks if not c["ok"]}


@pytest.mark.parametrize("program", ["sound", "one_iteration_short"])
def test_tiny_kitti_raft_cell(monkeypatch, program):
    ctx, cfg, out = _run(monkeypatch, short=program != "sound")
    assert out["judged"] == 1
    if program == "sound":
        assert _failed(out["checks"]) == set(), out["numbers"]
        assert out["numbers"]["raft_lookup_gap"] <= 1e-6
        # The control of the all-pairs volume in bf16, which the end flow
        # cannot tell from a sound run, fails by the lookup's number.
        n = control_raft.control_numbers(
            ctx, cfg, out["state_dict"], out["records"],
            control_raft.controls(cfg)["volume_bfloat16"])
        assert _failed(judge_serve.checks(n, stream_raft.LIMITS)) == {
            "raft_lookup_gap"}, n
    else:
        assert "flow_epe_px" in _failed(out["checks"])
