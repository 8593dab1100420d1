"""The serving flow stage's CUDA graphs (``pipeline._flow_forward``
through ``utils/cuda_graphs.py``) on the CPU: replays bitwise the eager
flow, what the key holds, that a graph keeps no net alive, the replay's
refresh of the parameters and buffers, the correlations and RAFT lookups
it launches between its segments, ``detect_step``'s routing and the
counters. What the flow shares with the tracker stage (the CPU and
autograd routing, the bound, the copy in and out) is in
``tests/test_torch_cuda_graphs.py``.

A CUDA graph needs a card: ``graph_stub.StubGraph`` stands in for the
captured graphs. The card's own graphs are held bitwise to the eager flow
in ``tests/test_torch_kernels_gpu.py``. The port alone: no JAX.
"""

import contextlib
import copy
import dataclasses
import gc
import io
import weakref

import numpy as np
import pytest
import torch

import graph_stub
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch import pipeline
from moving_object_detector_tpu_torch import run as trun
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.ops import flow_corr_cuda
from moving_object_detector_tpu_torch.utils import cuda_graphs, profiling

torch.set_num_threads(2)

H, W = 32, 48
FLOW_CFG = tcfg.FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                              use_context_net=False, dtype="float32")


def _net(seed=0):
    torch.manual_seed(seed)
    return PWCNet(FLOW_CFG)


def _pair(h=H, w=W, seed=4):
    img = torch.from_numpy(np.random.default_rng(seed).random(
        (h, w), np.float32))
    return img, img.roll(2, 1)


@pytest.fixture
def stub(monkeypatch):
    """The stub graph in place, empty caches, the routing as on a card."""
    graph_stub.as_on_a_card(monkeypatch)
    return graph_stub.install(monkeypatch)


def _captured(stub):
    """The image shape of each flow capture."""
    return [tuple(static[1].shape) for name, static in stub.captured
            if name == "flow"]


def _graphed(net, prev, now, scale=1, backend=None):
    return pipeline._flow_forward(net, prev, now, scale, backend)


@pytest.mark.parametrize("scale", [1, 2])
def test_replays_are_bitwise_the_eager_flow(stub, scale):
    """The first call returns the eager run of the capture; each later
    pair a copy of the replay's output, which the next replay leaves
    alone, each bitwise the eager flow of its pair."""
    net = _net()
    pairs = [_pair(seed=s) for s in range(4)]
    flows = []
    with profiling.recording() as rec:
        for k, (prev, now) in enumerate(pairs):
            profiling.set_unit(k)
            flows.append(_graphed(net, prev, now, scale))
    assert _captured(stub) == [(H, W)]
    for (prev, now), flow in zip(pairs, flows):
        assert torch.equal(flow, pipeline._flow_eager(net, prev, now, scale))
    assert [rec.counters[("flow_graph_captures", k)] for k in range(4)] == [
        1, 0, 0, 0]
    assert [rec.counters[("flow_graph_replays", k)] for k in range(4)] == [
        0, 1, 1, 1]


class _Segment:
    """A stand-in graph that logs its replay."""

    def __init__(self, log, k):
        self.log, self.k = log, k

    def replay(self):
        self.log.append(("segment", self.k))


def _flow_graph(net, segments, cuts, hw, **kw):
    """A ``cuda_graphs.Graph`` as the flow stage captures it: a copy of
    ``net``'s parameters and buffers and two images as its inputs, a flow
    as its output."""
    inputs = pipeline._state_tensors(copy.deepcopy(net)) + [
        torch.zeros(hw), torch.zeros(hw)]
    return cuda_graphs.Graph(segments, cuts, inputs,
                             torch.full(hw + (2,), 7.0), **kw)


def test_a_replay_launches_each_correlation_between_its_segments(
        monkeypatch):
    """Segment k, then the correlation cut after it through the module's
    ``corr_forward`` (which a benchmark's wrapper sees) into the buffer
    segment k + 1 reads, and the last segment; the caller's parameters and
    images copied in first, the output copied out."""
    net = _net()
    prev, now = _pair()
    log = []
    feats = [torch.rand(1, 3, 4, 6) for _ in range(4)]
    corrs = [(flow_corr_cuda, "corr_forward", (feats[0], feats[1], 1),
              torch.zeros(1, 9, 4, 6)),
             (flow_corr_cuda, "corr_forward", (feats[2], feats[3], 2),
              torch.zeros(1, 25, 4, 6))]
    real = flow_corr_cuda.corr_forward

    def logged(f1, f2, search_range, out=None):
        log.append(("corr", search_range))
        return real(f1, f2, search_range, out=out)

    monkeypatch.setattr(flow_corr_cuda, "corr_forward", logged)
    graph = _flow_graph(net, [_Segment(log, k) for k in range(3)], corrs,
                        (H, W))
    with torch.no_grad():
        net.estimators[0].flow_head.bias.add_(1.0)
    got = graph((pipeline._state_tensors(net), prev, now))
    assert log == [("segment", 0), ("corr", 1), ("segment", 1), ("corr", 2),
                   ("segment", 2)]
    for _, _, args, buf in corrs:
        assert torch.equal(buf, real(*args))
    assert torch.equal(graph.inputs[-2], prev)
    assert torch.equal(graph.inputs[-1], now)
    assert all(torch.equal(a, b) for a, b in zip(graph.inputs,
                                                 net.parameters()))
    assert torch.equal(got, graph.outputs)
    assert got.data_ptr() != graph.outputs.data_ptr()


def test_corr_forward_writes_into_out():
    f1, f2 = torch.rand(2, 1, 3, 5, 7).unbind(0)
    want = flow_corr_cuda.corr_forward(f1, f2, 2)
    buf = torch.zeros_like(want)
    assert flow_corr_cuda.corr_forward(f1, f2, 2, out=buf) is buf
    assert torch.equal(buf, want)


def test_the_key_follows_shape_scale_backend_and_configuration():
    net = _net()
    prev, now = _pair()

    def key(p=prev, n=now, scale=1, backend=None, model=net):
        return pipeline._flow_key(model, p, n, scale, backend)

    base = key()
    assert key(*_pair(H, W - 8)) != base
    assert key(scale=2) != base
    assert key(backend="pallas") != base
    # "auto" resolves to the plain form on the CPU: one graph for both.
    assert key(backend="xla") == base == key(backend="auto")
    assert key(prev.double(), now.double()) != base
    assert key(model=_net(seed=1)) == base  # the weights are not the key
    other = PWCNet(dataclasses.replace(FLOW_CFG, search_range=1))
    assert key(model=other) != base


@pytest.mark.parametrize("how", ["in_place", "replaced", "another_net"])
def test_a_replay_reads_the_callers_current_parameters(stub, how):
    """An update in place, a replaced parameter, or another net of the
    configuration: the same graph, its copy of the parameters refreshed,
    the flow bitwise the eager flow of the caller's net."""
    net = _net()
    prev, now = _pair()
    _graphed(net, prev, now)
    _graphed(net, prev, now)
    head = net.estimators[0].flow_head
    if how == "in_place":
        with torch.no_grad():
            head.bias.add_(1.0)
    elif how == "replaced":
        head.bias = torch.nn.Parameter(head.bias.detach() + 1.0)
    else:
        net = _net(seed=1)
    for a, b in ((prev, now), (now, prev)):
        flow = _graphed(net, a, b)
        assert torch.equal(flow, pipeline._flow_eager(net, a, b))
    assert len(_captured(stub)) == 1


def test_a_graph_keeps_no_reference_to_the_callers_net(stub):
    net = _net()
    _graphed(net, *_pair())
    gone = weakref.ref(net)
    del net
    gc.collect()
    assert gone() is None and len(pipeline._flow_cache.graphs) == 1


def _tiny_step_inputs():
    config = tcfg.PipelineConfig(
        height=H, width=W, flownet=FLOW_CFG,
        sgm=tcfg.SGMConfig(max_disparity=16, backend="xla"),
        egomotion=tcfg.EgoMotionConfig(max_features=64, nms_radius=2,
                                       ransac_hypotheses=16,
                                       lk_pyramid_levels=2, min_inliers=8),
        tracker=tcfg.TrackerConfig(max_tracks=4))
    from moving_object_detector_tpu_torch.types import StereoModel

    stereo = StereoModel.create(fx=50.0, fy=50.0, cx=W / 2, cy=H / 2,
                                baseline=0.5, device="cpu")
    state = pipeline.PipelineState.create(config, device="cpu")
    left, right = _pair()
    return config, stereo, state, left, right


def test_detect_step_takes_the_cache_unless_flow_is_given(stub):
    """With the routing as on a card, a step runs its flow through the
    cache; a step given ``flow_override`` does not, and counts neither
    counter."""
    net = _net()
    config, stereo, state, left, right = _tiny_step_inputs()
    with profiling.recording() as rec:
        state1, out = pipeline.detect_step(net, state, left, right, 0.0,
                                           stereo, config)
        pipeline.detect_step(net, state1, left, right, 0.1, stereo, config,
                             flow_override=torch.zeros(H, W, 2))
    assert _captured(stub) == [(H, W)]
    assert torch.equal(out.flow, pipeline._flow_eager(
        net, state.prev_left, left, config.flow_input_scale))
    assert rec.counters[("flow_graph_captures", 0)] == 1
    assert ("flow_graph_captures", 1) not in rec.counters
    assert ("flow_graph_replays", 1) not in rec.counters


def test_the_cli_report_prints_both_counters():
    """``run --report`` on the CPU: a row for each counter, at 0 a pair."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = trun.main(["--source", "synthetic", "--frames", "2",
                        "--preset", "tiny", "--height", "64", "--width",
                        "128", "--fx", "100", "--report"], device="cpu")
    assert rc == 0
    rows = {line.split()[1]: line.split()[2:]
            for line in err.getvalue().splitlines()
            if line.startswith("counter flow_graph_")}
    assert rows == {"flow_graph_captures": ["2", "0.000"],
                    "flow_graph_replays": ["2", "0.000"]}


def _raft(iters=2):
    from moving_object_detector_tpu_torch.utils.checkpoint import build_raft

    return build_raft(tcfg.RAFTConfig(dtype="float32", iters=iters), 0,
                      "cpu")


def test_a_replay_copies_buffers_with_the_parameters():
    """The copy list holds every parameter and then every buffer, so a
    batch norm's running statistics changed in the caller's net reach the
    graphs' copy at the next replay (RAFT's context encoder keeps them)."""
    net = _raft()
    listed = pipeline._state_tensors(net)
    params, buffers = list(net.parameters()), list(net.buffers())
    assert len(listed) == len(params) + len(buffers)
    assert all(a is b for a, b in zip(listed, params + buffers))
    assert any(t is net.cnet.norm1.running_mean for t in listed)
    prev, now = _pair(64, 64)
    graph = _flow_graph(net, [_Segment([], 0)], [], (64, 64))
    with torch.no_grad():
        net.cnet.norm1.running_mean.add_(1.0)
        net.cnet.layer2[0].norm3.running_var.mul_(3.0)
    graph((pipeline._state_tensors(net), prev, now))
    assert all(torch.equal(a, b) for a, b in zip(
        graph.inputs, pipeline._state_tensors(net)))


def test_a_replay_launches_each_lookup_between_its_segments(monkeypatch):
    """A RAFT graph: segment k, then the lookup cut after it through the
    module's ``raft_lookup`` into the buffer segment k + 1 reads; the
    counters the capture counted added; the first segment in span
    ``raft_encode``, the rest in ``raft_update``."""
    from moving_object_detector_tpu_torch.models.raft import (
        coords_grid, correlation_pyramid)
    from moving_object_detector_tpu_torch.ops import raft_lookup_cuda

    net = _raft()
    prev, now = _pair(64, 64)
    log = []
    f1, f2 = torch.rand(2, 1, 8, 4, 6).unbind(0)
    pyr = correlation_pyramid(f1, f2, 2)
    cuts = [(raft_lookup_cuda, "raft_lookup",
             (pyr, coords_grid(1, 4, 6, "cpu") + k, 4),
             torch.zeros(1, 162, 4, 6)) for k in range(2)]
    real = raft_lookup_cuda.raft_lookup

    def logged(pyramid, coords, radius, out=None):
        log.append(("lookup", len(pyramid)))
        return real(pyramid, coords, radius, out=out)

    monkeypatch.setattr(raft_lookup_cuda, "raft_lookup", logged)
    graph = _flow_graph(net, [_Segment(log, k) for k in range(3)], cuts,
                        (64, 64),
                        counters={"raft_iterations": 2, "raft_lookups": 2},
                        spans=net.replay_spans)
    with profiling.recording() as rec:
        profiling.set_unit(5)
        graph((pipeline._state_tensors(net), prev, now))
    assert log == [("segment", 0), ("lookup", 2), ("segment", 1),
                   ("lookup", 2), ("segment", 2)]
    for _, _, args, buf in cuts:
        assert torch.equal(buf, raft_lookup_cuda.raft_lookup_plain(*args))
    assert rec.counters[("raft_iterations", 5)] == 2
    assert rec.counters[("raft_lookups", 5)] == 2
    assert [s.name for s in rec.spans()] == ["raft_encode", "raft_update"]


def test_the_key_covers_the_raft_configuration():
    prev, now = _pair(64, 64)
    base = pipeline._flow_key(_raft(2), prev, now, 1, None)
    assert pipeline._flow_key(_raft(2), prev, now, 1, None) == base
    assert pipeline._flow_key(_raft(3), prev, now, 1, None) != base
    assert pipeline._flow_key(_raft(2), prev, now, 1, "pallas") != base
    assert pipeline._flow_key(_net(), prev, now, 1, None) != base
