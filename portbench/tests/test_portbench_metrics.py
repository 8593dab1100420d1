"""The metric arithmetic on known inputs."""

from __future__ import annotations

import math
import re

import pytest
import torch

from portbench.core import bench, flops, stats, trace
from portbench.drivers.stream import RunView

PWC = dict(in_channels=1, feature_channels=[16, 32, 64, 96, 128, 196],
           estimator_channels=[128, 128, 96, 64, 32],
           context_channels=[128, 128, 128, 96, 64, 32], search_range=4,
           occlusion_cue=True)


def test_p95_counts_drops_as_misses():
    lat = list(range(1, 96))  # 95 came back of 100 offered
    assert stats.latency_quantile(lat, 100, 0.95, 1e9) == 95
    assert stats.latency_quantile(lat[:-1], 100, 0.95, 1e9) == 1e9
    assert stats.latency_quantile([5.0] * 20, 20, 0.95, 1e9) == 5.0
    with pytest.raises(ValueError):
        stats.latency_quantile([1.0, 2.0], 1, 0.95, 1e9)
    with pytest.raises(ValueError):
        stats.latency_quantile([2e9], 1, 0.95, 1e9)


def test_nearest_rank_and_rate_and_spread():
    assert stats.nearest_rank([3, 1, 2, 4], 0.5) == 2
    assert stats.nearest_rank(range(1, 21), 0.95) == 19
    assert stats.rate(450, 30.0) == 15.0
    assert stats.spread([10, 10, 10, 10]) == 0.0
    assert stats.spread([9.0, 10.0, 11.0, 12.0, 8.0, 10.0]) == pytest.approx(
        (11.25 - 8.75) / 10.0)


def test_idle_share_from_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union_seconds(iv) == 3.0
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    view = RunView("serve", trace={"launches": 3, "busy_s": 3.0,
                                   "window_s": 5.0, "units": 1})
    reader = bench.metric_reader("device_idle_share.max")
    assert reader.read(view, "device_idle_share.max") == pytest.approx(40.0)
    assert bench.metric_reader("launches_per_pair.max").read(
        view, "launches_per_pair.max") == 3.0
    assert bench.metric_reader("launches_per_step.train").read(
        view, "launches_per_step.train") is None


def test_host_op_at_takes_the_innermost():
    cpu = sorted([("outer", 0.0, 10.0), ("inner", 2.0, 4.0),
                  ("later", 6.0, 7.0)], key=lambda c: c[1])
    starts = [c[1] for c in cpu]
    assert trace.host_op_at(cpu, starts, 3.0) == "inner"
    assert trace.host_op_at(cpu, starts, 5.0) == "outer"
    assert trace.host_op_at(cpu, starts, 11.0) == "no host operation"


def test_pwc_flops_at_the_serving_point():
    """13.36 GFLOP a pair: the net runs at 192 x 640, 188 x 621 padded to
    multiples of 64."""
    assert flops.padded(188, 621, 6) == (192, 640)
    n = flops.from_config(PWC, 1, 188, 621)
    assert n == pytest.approx(13.40e9, rel=2e-3)
    assert 3 * flops.from_config(PWC, 8, 384, 448) == pytest.approx(
        3 * 150.0e9, rel=5e-3)


def test_pwc_flops_match_the_flop_counter():
    """The count equals ``torch.utils.flop_counter``'s convolutions on the
    reference net, computed on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import config, pwc_net

    cfg = config.FlowNetConfig(dtype="float32", occlusion_cue=True)
    with torch.device("meta"):
        net = pwc_net.PWCNet(cfg)
        x = torch.zeros(2, 1, 128, 192)
        with FlopCounterMode(display=False) as fc:
            net(x, x)
    conv = fc.get_flop_counts()["Global"][torch.ops.aten.convolution]
    assert flops.from_config(PWC, 2, 128, 192) == conv


def test_bounds_from_shapes():
    b = {m.NAME: m for m in bench.bound_modules()}
    t = torch.empty((1, 196, 3, 10), device="meta")
    nb, ops = b["corr"].bytes_ops(t, t, 4)
    assert nb == (2 * 196 + 81) * 30 * 4 and ops == 2 * 81 * 196 * 30
    s, by = trace.bound_seconds(nb, ops)
    assert by == "bytes" and s == pytest.approx(nb / 3.35e12)
    from portbench.reference.config import EgoMotionConfig

    pts = torch.empty((512, 3), device="meta")
    idx = torch.empty((64, 3), device="meta")
    nb, ops = b["ransac_gn"].bytes_ops(pts, pts, pts, pts, idx,
                                       EgoMotionConfig())
    assert trace.bound_seconds(nb, ops) == (ops / 67e12, "operations")
    # PERF.md's row 13: 0.000135 ms, bound by the operations.
    assert ops / 67e12 * 1e3 == pytest.approx(0.000135, rel=0.01)
    cl = torch.empty((188, 621), device="meta")
    nb, ops = b["sgm_vertical"].bytes_ops(cl, cl, 10, 120)
    assert trace.bound_seconds(nb, ops)[1] == "bytes"
    assert trace.bound_seconds(nb, ops)[0] * 1e3 == pytest.approx(0.0092,
                                                                 abs=5e-5)
    assert b["cc"].bytes_ops(cl)[0] == 9 * 188 * 621
    assert trace.bound_seconds(*b["cc"].bytes_ops(cl))[1] == "bytes"


def test_device_names_pick_their_kernels():
    b = {m.NAME: m for m in bench.bound_modules()}
    assert b["sgm_wta"].DEVICE_NAME.search(
        "void wta_kernel<true>(signed char const*, signed char const*)")
    assert not b["sgm_wta"].DEVICE_NAME.search(
        "void wta_kernel<true>(short const*, float*, int*, int)")
    assert b["corr"].DEVICE_NAME.search("void corr_kernel<4, true>(float")
    assert not b["corr"].DEVICE_NAME.search("void corr_bwd_kernel<4, true>(")
    for name in b:
        assert isinstance(b[name].DEVICE_NAME, re.Pattern)


def test_roofline_and_mfu_readers():
    view = RunView("train", trace={"launches": 10, "busy_s": 1.0,
                                   "window_s": 2.0, "units": 5, "kernels": [
        dict(calls=4, device_s=2e-3, bound_s=5e-4),
        dict(calls=0, device_s=1e-3, bound_s=0.0)]})
    r = bench.metric_reader("kernel_roofline.train")
    assert r.read(view, "kernel_roofline.train") == pytest.approx(25.0)
    view.flops_per_unit, view.units_completed, view.units_seconds = (
        449.0e9, 989, 0.449)
    assert bench.metric_reader("step_mfu.train").read(
        view, "step_mfu.train") == pytest.approx(100.0)
    assert bench.metric_reader("dispatch_ms.max").read(view, "x") is None
    serve = RunView("serve", stage_ms={"dispatch": [1.0, 3.0],
                                       "harvest": [2.0]})
    assert bench.metric_reader("dispatch_ms.live").read(serve, "x") == 2.0
    assert bench.metric_reader("harvest_ms.max").read(serve, "x") == 2.0
    assert math.isclose(
        bench.metric_reader("kernel_roofline.max").read(serve, "x") or 0, 0)


def test_host_probe_reads_the_window():
    from portbench.core import host

    probe = host.Probe("cpu")
    probe.start()
    host.python_ms()
    probe.stop()
    s = probe.summary()
    assert s["before"]["python_ms"] > 0 and s["after"]["launch_us"] > 0
    assert s["window"]["wall_s"] > 0 and s["window"]["own_cores"] >= 0
