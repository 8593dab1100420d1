"""The port's one CUDA-graph cache (``utils/cuda_graphs.py``) on the CPU,
through both stages that take it, the flow (``pipeline._flow_forward``)
and the tracker (``tracker.track_frame``): what routes to it, the bound,
the copy in and the copy out; then the cut point a kernel wrapper calls
and the graphability test.

A CUDA graph needs a card: ``graph_stub.StubGraph`` stands in for the
captured graphs, and ``graph_stub.as_on_a_card`` makes ``graphable`` take
the CPU tensors for CUDA ones. The port alone: no JAX.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import graph_stub
from tracker_cases import CASES
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch import pipeline
from moving_object_detector_tpu_torch import tracker as ttr
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.types import MovingObjects
from moving_object_detector_tpu_torch.utils import (cuda_graphs, profiling,
                                                    trees)

torch.set_num_threads(2)

H, W = 32, 48
FLOW_CFG = tcfg.FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                              use_context_net=False, dtype="float32")
STAGES = ["flow", "tracker"]


def _equal(a, b):
    """Every tensor of two trees bitwise equal (NaN equal to NaN)."""
    la, lb = trees.leaves(a), trees.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.detach().numpy().tobytes() == y.detach().numpy().tobytes()


class _Flow:
    """The flow stage on a small PWC-Net; a signature is an image width."""

    def __init__(self):
        torch.manual_seed(0)
        self.net = PWCNet(FLOW_CFG)

    def inputs(self, sig=0, seed=4):
        img = torch.from_numpy(np.random.default_rng(seed).random(
            (H, W + 8 * sig), np.float32))
        return img, img.roll(2, 1)

    def track(self, inputs):
        inputs[0].requires_grad_(True)

    def run(self, inputs):
        return pipeline._flow_forward(self.net, *inputs)

    def eager(self, inputs):
        return pipeline._flow_eager(self.net, *inputs)

    def sequence(self, n):
        """``n`` calls of one signature: [(result, eager result)]."""
        out = []
        for k in range(n):
            pair = self.inputs(seed=k)
            out.append((self.run(pair), self.eager(pair)))
        return out


class _Tracker:
    """The tracker stage on ``tests/tracker_cases.py``'s frames; a
    signature is a track capacity and a configuration."""

    SIGS = [(8, {}), (4, {}), (8, {"object_radius": 0.1})]

    def inputs(self, sig=0):
        cap, kw = self.SIGS[sig]
        return self.frame_args(ttr.TrackerState.create(cap, "cpu"),
                               CASES["adjacent_spawn"][0]()[0],
                               ttr.TrackerConfig(max_tracks=cap, **kw))

    @staticmethod
    def frame_args(state, frame, cfg):
        t, center, velocity, bbox, valid, frame_valid = frame
        ids = np.where(valid, np.arange(valid.shape[0]), -1).astype(np.int32)
        dets = MovingObjects(*map(torch.from_numpy, (
            ids, center, velocity, bbox, valid)))
        return state, float(t), dets, torch.tensor(frame_valid), cfg

    def track(self, inputs):
        inputs[2].center.requires_grad_(True)

    def run(self, inputs):
        return ttr.track_frame(*inputs)

    def eager(self, inputs):
        state, t, dets, frame_valid, cfg = inputs
        return ttr._track_frame_eager(
            cfg, state, torch.tensor(t), dets, frame_valid,
            torch.tensor(cfg.object_radius),
            torch.tensor(cfg.covariance_trace_limit),
            torch.tensor(cfg.correction_count_limit, dtype=torch.int32))

    def sequence(self, n=None):
        """The serving frames (64 tracks, 16 detections), each pair's state
        the one the stage returned: [(result, eager result)]."""
        make, cap = CASES["serving"]
        cfg = ttr.TrackerConfig(max_tracks=cap)
        state = eager = ttr.TrackerState.create(cap, "cpu")
        out = []
        for frame in make()[:n]:
            got = self.run(self.frame_args(state, frame, cfg))
            want = self.eager(self.frame_args(eager, frame, cfg))
            out.append((got, want))
            state, eager = got[0], want[0]
        return out


def _stage(name):
    return _Flow() if name == "flow" else _Tracker()


@pytest.fixture
def on_a_card(monkeypatch):
    """The stub graph in place, empty caches, ``graphable`` as on a card."""
    graph_stub.as_on_a_card(monkeypatch)
    return graph_stub.install(monkeypatch)


def _counts(rec, name, n):
    return [(rec.counters[(f"{name}_graph_captures", k)],
             rec.counters[(f"{name}_graph_replays", k)]) for k in range(n)]


@pytest.mark.parametrize("name", STAGES)
def test_cpu_and_tracked_inputs_capture_nothing_and_count_zero(
        name, monkeypatch):
    """CPU inputs, and on a card inputs autograd tracks, run the stage
    eagerly, capture nothing and count 0 captures and 0 replays; the same
    inputs untracked on a card capture."""
    stage = _stage(name)
    stub = graph_stub.install(monkeypatch)
    cache = pipeline._flow_cache if name == "flow" else ttr._tracker_cache
    results = []
    with profiling.recording() as rec:
        profiling.set_unit(0)
        inputs = stage.inputs()
        results.append((stage.run(inputs), stage.eager(inputs)))
        assert not cache.graphs and not stub.captured
        graph_stub.as_on_a_card(monkeypatch)
        for k, tracked in ((1, True), (2, False)):
            profiling.set_unit(k)
            inputs = stage.inputs()
            if tracked:
                stage.track(inputs)
            results.append((stage.run(inputs), stage.eager(inputs)))
    for got, want in results:
        _equal(got, want)
    assert _counts(rec, name, 3) == [(0, 0), (0, 0), (1, 0)]
    assert ((f"{name}_graph_replays", 0) in rec.counters
            and (f"{name}_graph_replays", 1) in rec.counters)
    assert [n for n, _ in stub.captured] == [name] and len(cache.graphs) == 1


@pytest.mark.parametrize("name", STAGES)
def test_past_the_bound_a_signature_runs_eagerly_and_no_graph_is_freed(
        name, monkeypatch, on_a_card):
    """Two signatures capture a graph each; past ``MAX_GRAPHS`` (2 here) a
    third runs eagerly, counted as neither, and the first replays its
    graph, which is still the one captured."""
    stage = _stage(name)
    cache = pipeline._flow_cache if name == "flow" else ttr._tracker_cache
    monkeypatch.setattr(cuda_graphs, "MAX_GRAPHS", 2)
    with profiling.recording() as rec:
        for k, sig in enumerate((0, 1, 2, 0)):
            profiling.set_unit(k)
            inputs = stage.inputs(sig)
            _equal(stage.run(inputs), stage.eager(inputs))
            if k == 1:
                first = list(cache.graphs.values())
    assert _counts(rec, name, 4) == [(1, 0), (1, 0), (0, 0), (0, 1)]
    assert list(cache.graphs.values()) == first
    assert len(on_a_card.captured) == 2


@pytest.mark.parametrize("name", STAGES)
def test_a_replay_copies_in_and_returns_copies(name, on_a_card):
    """The first call of a signature captures and returns the eager
    result, the later ones replay: each bitwise the eager stage on its
    inputs copied in, each returned result unchanged by the later
    replays; 1 capture, then 1 replay a call."""
    stage = _stage(name)
    with profiling.recording() as rec:
        profiling.set_unit(0)
        pairs = stage.sequence(4 if name == "flow" else None)
    kept = []
    for got, want in pairs:
        _equal(got, want)
        kept.append(([x.clone() for x in trees.leaves(got)], got))
    for copies, got in kept:
        assert all(torch.equal(a, b)
                   for a, b in zip(copies, trees.leaves(got)))
    n = len(pairs)
    assert rec.counters[(f"{name}_graph_captures", 0)] == 1
    assert rec.counters[(f"{name}_graph_replays", 0)] == n - 1
    assert [s for s, _ in on_a_card.captured] == [name]


def test_a_cut_kernel_launches_through_its_module_attribute(monkeypatch):
    """While a capture runs, each call of a wrapper's ``cut_point`` ends
    the graph, keeps the launch and an output buffer, begins the next
    graph and hands the buffer back; a replay launches each between its
    graphs through the module attribute as it is then, so a wrapper set
    after the capture is the one called."""
    log, made, capturing = [], [], [False]

    class FakeGraph:
        """Stands in for ``torch.cuda.CUDAGraph``."""

        def __init__(self):
            self.k = len(made)
            made.append(self)

        def capture_begin(self, pool=None, capture_error_mode=None):
            log.append(("begin", self.k))
            capturing[0] = True

        def capture_end(self):
            log.append(("end", self.k))
            capturing[0] = False

        def replay(self):
            log.append(("segment", self.k))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    mod = types.ModuleType("stand_in_kernels")

    def scale(x, k, out=None):
        cut = cuda_graphs.cut_point(mod.__name__, "scale", (x, k), x.shape,
                                    torch.float32, x.device)
        if cut is not None:
            return cut
        log.append(("launch", k))
        return out.copy_(x * k)

    mod.scale = scale
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    x = torch.arange(4.0)
    capture = cuda_graphs._Capture()
    out = capture.run(lambda a: mod.scale(mod.scale(a + 1, 2) - 1, 3), (x,))
    assert cuda_graphs._cutting is None
    assert log == [("begin", 0), ("end", 0), ("begin", 1), ("end", 1),
                   ("begin", 2), ("end", 2)]
    assert [(m, n, a[1]) for m, n, a, _ in capture.cuts] == [
        (mod, "scale", 2), (mod, "scale", 3)]
    assert out is capture.cuts[1][3]
    log.clear()

    def replaced(x, k, out=None):
        log.append(("replaced", k))
        return scale(x, k, out=out)

    monkeypatch.setattr(mod, "scale", replaced)
    graph = cuda_graphs.Graph(capture.segments, capture.cuts, [x], out)
    got = graph((torch.arange(4.0),))
    assert log == [("segment", 0), ("replaced", 2), ("launch", 2),
                   ("segment", 1), ("replaced", 3), ("launch", 3),
                   ("segment", 2)]
    assert torch.equal(capture.cuts[0][3], (x + 1) * 2)
    assert torch.equal(got, out) and got.data_ptr() != out.data_ptr()


def test_graphable_follows_device_and_autograd():
    """CUDA tensors replay a graph whatever the grad mode, unless autograd
    tracks one of them; CPU tensors never do."""
    def t(device, requires_grad=False):
        return types.SimpleNamespace(device=torch.device(device),
                                     requires_grad=requires_grad)

    cuda, cpu = t("cuda"), t("cpu")
    assert cuda_graphs.graphable(cuda, cuda)
    with torch.no_grad():
        assert cuda_graphs.graphable(cuda, t("cuda", True))
    assert not cuda_graphs.graphable(cuda, t("cuda", True))
    assert not cuda_graphs.graphable(t("cuda", True), cuda)
    assert not cuda_graphs.graphable(cpu, cpu)


def test_the_tree_walk_visits_fields_items_and_values_in_one_order():
    """``leaves`` lists the tensors ``map_tensors`` visits, in its order,
    through dataclasses, tuples, lists and dicts, other leaves left out."""
    @dataclasses.dataclass(frozen=True)
    class Pair:
        a: torch.Tensor
        b: object

    tree = (Pair(torch.zeros(1), [torch.ones(2), None, {"k": torch.ones(3)}]),
            3.0, torch.zeros(4))
    seen = []
    trees.map_tensors(tree, seen.append)
    assert [x.numel() for x in trees.leaves(tree)] == [1, 2, 3, 4]
    assert all(x is y for x, y in zip(seen, trees.leaves(tree)))
    bumped = trees.map_tensors(tree, lambda x: x + 1)
    assert isinstance(bumped[0], Pair) and bumped[1] == 3.0
    assert bumped[0].b[1] is None and float(bumped[2][0]) == 1.0
