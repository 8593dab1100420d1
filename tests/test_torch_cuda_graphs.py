"""The port's one CUDA-graph cache (``utils/cuda_graphs.py``) on the CPU,
through the stages that take it, the flow (``pipeline._flow_forward``),
the tracker (``tracker.track_frame``) and ego-motion
(``egomotion.estimate_motion``): what routes to it, the bound, the copy
in and the copy out; ego-motion's two halves and the draw they take; then
the cut point a kernel wrapper calls and the graphability test.

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
from moving_object_detector_tpu_torch import egomotion as tego
from moving_object_detector_tpu_torch import pipeline
from moving_object_detector_tpu_torch import tracker as ttr
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.ops import gauss_newton_cuda
from moving_object_detector_tpu_torch.types import (CameraModel,
                                                    DisparityImage,
                                                    MovingObjects)
from moving_object_detector_tpu_torch.utils import (cuda_graphs, profiling,
                                                    trees)

torch.set_num_threads(2)

H, W = 32, 48
FLOW_CFG = tcfg.FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                              use_context_net=False, dtype="float32")
STAGES = ["flow", "tracker", "egomotion"]


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


class _Ego:
    """Ego-motion on a textured plane 5 m ahead, the camera moved 2 px to
    the left between the frames (the exact flow, so no pair falls back
    unless its configuration forces it); a signature is an image width."""

    CFG = tcfg.EgoMotionConfig(max_features=64, nms_radius=2,
                               lk_pyramid_levels=2, lk_window=5, lk_iters=4,
                               ransac_hypotheses=16, min_inliers=8)
    FORCED = dataclasses.replace(CFG, lk_fallback_frac=1.01)
    FX, Z0, BASELINE = 60.0, 5.0, 0.5

    def inputs(self, sig=0, seed=4, cfg=None, dense=True):
        h, w = 48, 64 + 8 * sig
        rng = np.random.default_rng(seed)
        img = np.kron(rng.random((h // 4, w // 4)), np.ones((4, 4)))
        prev = torch.from_numpy(img.astype(np.float32))
        prev = (prev + prev.roll(1, 0) + prev.roll(1, 1)) / 3.0
        disp = DisparityImage.create(
            torch.full((h, w), self.FX * self.BASELINE / self.Z0),
            f=self.FX, t=self.BASELINE)
        cam = CameraModel.create(self.FX, self.FX, w / 2.0, h / 2.0,
                                 device="cpu")
        flow = torch.zeros((h, w, 2))
        flow[..., 0] = 2.0
        return (prev, prev.roll(2, 1), disp, cam, seed, cfg or self.CFG,
                flow if dense else None)

    def track(self, inputs):
        inputs[0].requires_grad_(True)

    def run(self, inputs):
        prev, now, disp, cam, seed, cfg, flow = inputs
        gen = torch.Generator().manual_seed(seed)
        return tego.estimate_motion(prev, now, disp, cam, gen, cfg,
                                    dense_flow=flow), gen.get_state()

    def eager(self, inputs):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(cuda_graphs, "graphable", lambda *ts: False)
            return self.run(inputs)

    def sequence(self, n):
        """``n`` calls of one signature: [(result, eager result)]."""
        return [(self.run(self.inputs(seed=k)), self.eager(self.inputs(
            seed=k))) for k in range(n)]


def _stage(name):
    return {"flow": _Flow, "tracker": _Tracker, "egomotion": _Ego}[name]()


def _cache(name):
    return {"flow": pipeline._flow_cache, "tracker": ttr._tracker_cache,
            "egomotion": tego._dense_cache}[name]


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
    cache = _cache(name)
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
    cache = _cache(name)
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
        pairs = stage.sequence(None if name == "tracker" else 4)
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


def _fake_graphs(monkeypatch) -> list:
    """``torch.cuda.CUDAGraph`` and the capture state replaced by stand-ins
    that log to the returned list: ("register", k, generator), ("begin",
    k), ("end", k) and ("segment", k) of the k-th graph made."""
    log, made, capturing = [], [], [False]

    class FakeGraph:
        """Stands in for ``torch.cuda.CUDAGraph``."""

        def __init__(self):
            self.k = len(made)
            made.append(self)

        def register_generator_state(self, generator):
            log.append(("register", self.k, generator))

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
    return log


def test_a_cut_kernel_launches_through_its_module_attribute(monkeypatch):
    """While a capture runs, each call of a wrapper's ``cut_point`` ends
    the graph, keeps the launch and an output buffer, begins the next
    graph and hands the buffer back; a replay launches each between its
    graphs through the module attribute as it is then, so a wrapper set
    after the capture is the one called."""
    log = _fake_graphs(monkeypatch)
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


def test_a_three_output_cut_and_the_generators_each_segment_reads(
        monkeypatch):
    """A wrapper with three outputs (the RANSAC's motion, success and
    count) cuts with a tuple of shapes and dtypes: the capture hands back
    three buffers, and a replay launches the wrapper between the graphs
    with them as ``out``. A capture given generators registers each with
    every segment before it begins."""
    log = _fake_graphs(monkeypatch)
    mod = types.ModuleType("stand_in_solver")

    def solve(x, k, out=None):
        cut = cuda_graphs.cut_point(
            mod.__name__, "solve", (x, k), ((4, 4), (), ()),
            (torch.float32, torch.bool, torch.int32), x.device)
        if cut is not None:
            return cut
        log.append(("launch", k))
        motion, ok, count = out
        return (motion.copy_(torch.eye(4) * x.sum()), ok.fill_(k > 1),
                count.fill_(k))

    mod.solve = solve
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    gens = (torch.Generator(), torch.Generator())
    capture = cuda_graphs._Capture(gens)
    out = capture.run(lambda a: mod.solve(a * 2, 3), (torch.ones(2),))
    assert [e[:2] for e in log] == [
        ("register", 0), ("register", 0), ("begin", 0), ("end", 0),
        ("register", 1), ("register", 1), ("begin", 1), ("end", 1)]
    assert [e[2] for e in log if e[0] == "register"] == list(gens) * 2
    ((_, name, args, bufs),) = capture.cuts
    assert name == "solve" and args[1] == 3 and out is bufs
    assert [(tuple(b.shape), b.dtype) for b in bufs] == [
        ((4, 4), torch.float32), ((), torch.bool), ((), torch.int32)]
    log.clear()
    x = torch.ones(2)
    graph = cuda_graphs.Graph(capture.segments, capture.cuts, [x], out)
    motion, ok, count = graph((torch.full((2,), 5.0),))
    assert log == [("segment", 0), ("launch", 3), ("segment", 1)]
    assert torch.equal(motion, torch.eye(4) * 4.0)
    assert bool(ok) and int(count) == 3 and motion.data_ptr() != \
        bufs[0].data_ptr()


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5, (7 << 32) + 12])
def test_the_capture_safe_draw_is_bitwise_multinomial(seed):
    """``egomotion._draw`` gives ``torch.multinomial``'s indices without
    replacement for the same seeded generator, two draws in a row (the
    dense RANSAC's and the LK fallback's), over the RANSAC's weights:
    valid features 1, the others the 1e-20 floor, also where fewer than
    three are valid."""
    rng = np.random.default_rng(seed % 2 ** 32)
    for n, valid in ((512, 0.7), (37, 0.3), (16, 0.0)):
        feat_valid = torch.from_numpy(rng.random(n) < valid)
        p = torch.clamp(feat_valid.float(), min=1e-20).expand(64, n)
        a = torch.Generator().manual_seed(seed)
        b = torch.Generator().manual_seed(seed)
        for _ in range(2):
            want = torch.multinomial(p, 3, replacement=False, generator=a)
            assert torch.equal(tego._draw(p, 3, b), want)
        assert torch.equal(a.get_state(), b.get_state())


def test_egomotion_halves_replay_their_graphs_bitwise_with_counters(
        on_a_card):
    """Dense pairs replay the dense half's graph; a forced-fallback
    configuration captures a dense graph of its own and the LK half's, and
    its pairs replay both; a pair without a dense flow takes the LK-only
    graph. Each result and the caller's generator after the stage bitwise
    the eager stage's; counters a pair: the dense graph's captures and
    replays, ``egomotion_lk_fallbacks``, and the LK graph's replays equal
    to the fallbacks."""
    stage = _Ego()
    plan = [dict(), dict(), dict(cfg=_Ego.FORCED), dict(cfg=_Ego.FORCED),
            dict(), dict(dense=False), dict(dense=False)]
    eager = [stage.eager(stage.inputs(seed=k, **kw))
             for k, kw in enumerate(plan)]
    with profiling.recording() as rec:
        for k, kw in enumerate(plan):
            profiling.set_unit(k)
            _equal(stage.run(stage.inputs(seed=k, **kw)), eager[k])

    def read(name):
        return [rec.counters[(name, k)] for k in range(len(plan))]

    assert read("egomotion_graph_captures") == [1, 0, 1, 0, 0, 0, 0]
    assert read("egomotion_graph_replays") == [0, 1, 0, 1, 1, 0, 0]
    assert read("egomotion_lk_fallbacks") == [0, 0, 1, 1, 0, 0, 0]
    assert read("egomotion_lk_graph_captures") == [0, 0, 1, 0, 0, 1, 0]
    assert read("egomotion_lk_graph_replays") == [0, 0, 0, 1, 0, 0, 1]
    assert [n for n, _ in on_a_card.captured] == [
        "egomotion", "egomotion", "egomotion_lk", "egomotion_lk"]
    assert len(tego._dense_cache.graphs) == 2
    assert len(tego._lk_cache.graphs) == 2
    assert all(bool(r[1]) for r, _ in eager)


def test_an_injected_draw_runs_the_egomotion_stage_eagerly(on_a_card):
    """Injected hypothesis indices (a test's own draw) run the stage
    eagerly: no graph captured, 0 captures and replays counted."""
    stage = _Ego()
    prev, now, disp, cam, _, cfg, flow = stage.inputs()
    idx = torch.arange(48).reshape(16, 3) % 40
    with profiling.recording() as rec:
        profiling.set_unit(0)
        got = tego.estimate_motion(prev, now, disp, cam, None, cfg,
                                   dense_flow=flow, sample_idx=idx)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_graphs, "graphable", lambda *ts: False)
        want = tego.estimate_motion(prev, now, disp, cam, None, cfg,
                                    dense_flow=flow, sample_idx=idx)
    _equal(got, want)
    assert not on_a_card.captured
    assert rec.counters[("egomotion_graph_captures", 0)] == 0
    assert rec.counters[("egomotion_graph_replays", 0)] == 0


def test_the_ransac_wrapper_writes_into_given_buffers():
    """``ransac_solve`` on CPU tensors with ``out`` (a graph's cut
    buffers) writes the plain version's result into them and returns
    them."""
    stage = _Ego()
    prev, _, disp, cam, _, cfg, _ = stage.inputs()
    pts, pts3d, valid = tego._features(prev, disp, cam, cfg, border=2)
    idx = torch.arange(48).reshape(16, 3) % int(valid.sum())
    vec = gauss_newton_cuda.camera_vector(cam)
    want = gauss_newton_cuda.ransac_solve(pts3d, pts + 2.0, valid, vec, idx,
                                          cfg)
    out = (torch.empty((4, 4)), torch.empty((), dtype=torch.bool),
           torch.empty((), dtype=torch.int32))
    got = gauss_newton_cuda.ransac_solve(pts3d, pts + 2.0, valid, vec, idx,
                                         cfg, out=out)
    assert all(a is b for a, b in zip(got, out))
    _equal(got, want)


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
