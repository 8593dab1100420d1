"""Serving cells of a RAFT configuration: stereo pairs through
``PipelineRunner.run`` into ``pipeline.detect_step`` with the program's
RAFT as the flow net, the drive and the loops of ``stream.py``.

The net's weights are drawn once from the configuration's ``init_seed``
(the repository holds no RAFT checkpoint), loaded into the program's net
(``utils.checkpoint.build_raft``) and, the same values, into the plain
reference's (``reference/raft.py``). The end-to-end metrics are
``stream.py``'s. The operations a pair (``step_mfu``) are RAFT's
(``core/flops_raft.py``). In a ``--trace 1`` run the window runs inside
the program's span recorder (``utils/profiling.py``), and the traced
part's device milliseconds a pair by span (``raft_encode``,
``raft_update``, ``flow``) go on the run's view; its counters and the
stages' host and device milliseconds go to standard error.

The judge is ``stream.py``'s, stage by stage against the reference, with
a limit of RAFT's own on the flow (``LIMITS``), and one more compared
number, ``raft_lookup_gap``: on the first sampled pair, the features of
the program's first lookup (the all-pairs volume of its own features,
pooled and sampled at each pixel's own place) against the reference's of
the same images, mean absolute gap over the reference's mean magnitude.
The end flow alone cannot tell an all-pairs volume computed in bf16 from
one in f32: the lookup's features enter the update block's bf16
convolutions, and 24 iterations of a net of random weights spread the
rounding of a sound run as widely (PERF.md).

A checkout whose program has no RAFT stops in set-up with no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from ..core import bench, configs, flops_raft, host, judge_serve, stats, \
    trace
from ..traffic import scene as scene_mod
from .stream import RunView, _Capture, _closed_loop, _open_loop, _paced

# Each compared number's limit; the readings each was set from are in
# PERF.md.
LIMITS = dict(judge_serve.LIMITS, flow_epe_px=0.08, raft_lookup_gap=1e-4)
# The spans whose device milliseconds a traced run reads, and the stages
# it logs beside them.
SPANS = ("raft_encode", "raft_update", "flow")
STAGES = ("sgm", "egomotion", "scene_flow", "clusterer", "tracker",
          "dispatch")


@dataclasses.dataclass
class RaftView(RunView):
    """``RunView`` with the traced part's device ms a pair by span."""

    span_device_ms: dict = dataclasses.field(default_factory=dict)


def flownet_group(cfg: dict) -> dict:
    """The configuration's ``flownet`` group as ``RAFTConfig`` fields."""
    return configs.values({k: v for k, v in cfg["flownet"].items()
                           if k not in ("arch", "init_seed")})


def program_net(cfg: dict, device):
    """(the program's RAFT, its configuration, its state dict on the
    host)."""
    try:
        from moving_object_detector_tpu_torch.config import RAFTConfig
        from moving_object_detector_tpu_torch.utils.checkpoint import \
            build_raft
    except ImportError as e:
        raise bench.BenchError(f"the program has no RAFT: {e}")
    net_cfg = RAFTConfig(**flownet_group(cfg))
    model = build_raft(net_cfg, cfg["flownet"]["init_seed"], device)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    return model, net_cfg, state


class _Grab:
    """Keeps a copy of the first lookup's features of the pair it is
    armed for: wraps the lookup the net calls (the kernel's wrapper, or
    the plain version), in the stream's order, so a CUDA graph's replay
    is caught too."""

    def __init__(self):
        from moving_object_detector_tpu_torch.ops import raft_lookup_cuda

        self.mod = raft_lookup_cuda
        self.armed = False
        self.features = None
        self.originals = {n: getattr(raft_lookup_cuda, n)
                          for n in ("raft_lookup", "raft_lookup_plain")}
        for name, orig in self.originals.items():
            setattr(raft_lookup_cuda, name, self._wrap(orig))

    def _wrap(self, orig):
        def grabbed(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.armed and out is not None:
                self.features = out.clone()
                self.armed = False
            return out
        return grabbed

    def restore(self):
        for name, orig in self.originals.items():
            setattr(self.mod, name, orig)


class _RaftCapture(_Capture):
    """``stream._Capture`` that arms the lookup's grab for the first
    sampled pair."""

    def __init__(self, real, fps, recorder, grab):
        super().__init__(real, fps, recorder)
        self.grab = grab
        self.grab_pair = None

    def __call__(self, flow_model, state, left, right, t, *args, **kwargs):
        j = self.index(t)
        self.grab.armed = j == self.grab_pair
        try:
            return super().__call__(flow_model, state, left, right, t, *args,
                                    **kwargs)
        finally:
            self.grab.armed = False


def run(ctx) -> dict:
    from moving_object_detector_tpu_torch import StereoModel
    from moving_object_detector_tpu_torch import config as pconfig
    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner
    from moving_object_detector_tpu_torch.utils import profiling
    from moving_object_detector_tpu_torch.utils.profiling import StageTimer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    h, w = cfg["height"], cfg["width"]
    fx, baseline = cfg["camera"]["fx"], cfg["camera"]["baseline"]
    bench.build_kernels(dev)
    model, net_cfg, state_dict = program_net(cfg, dev)
    config = dataclasses.replace(
        configs.pipeline_config(pconfig, {k: v for k, v in cfg.items()
                                          if k != "flownet"}),
        flownet=net_cfg)
    stereo = StereoModel.create(fx, fx, w / 2.0, h / 2.0, baseline,
                                device=dev)

    sc = scene_mod.params(tr)
    frames = scene_mod.render(sc, h, w, fx, baseline, ctx.seed, dev)
    distinct, fps = sc["pairs"], sc["fps"]
    bench.reset_peak(dev)

    recorder = (trace.Recorder(bench.bound_modules(), dev) if ctx.trace
                else None)
    grab = _Grab()
    capture = _RaftCapture(pipeline.detect_step, fps, recorder, grab)
    pipeline.detect_step = capture  # the runner looks it up at each run()
    runner = PipelineRunner(config, stereo, model,
                            ring_capacity=tr["ring_capacity"],
                            drop_oldest=tr["drop_oldest"], device=dev)
    warm = tr["warmup_pairs"]
    open_loop = tr["arrival"] == "open"
    runner.run(_paced(frames, distinct, 0, warm, fps,
                      1.5 / tr["rate"] if open_loop else 0.0))
    state = runner.final_state
    runner.timer = StageTimer()

    rng = np.random.default_rng(ctx.seed)
    seconds = ctx.seconds
    if open_loop:
        n_win = int(round(tr["rate"] * seconds))
        span = n_win
    else:
        n_win = None
        span = int(tr["check_rate"] * seconds)
    sample = warm + 2 + rng.choice(span - 4, size=tr["check_pairs"],
                                   replace=False)
    capture.sample = {int(j) for j in sample}
    capture.grab_pair = int(min(sample))
    marks = {"late": [], "offered": 0}
    if recorder is not None:
        capture.trace_pairs = tr["trace_pairs"]
    window_first = len(capture.order)
    probe = host.Probe(dev)
    spans = profiling.SpanRecorder() if recorder is not None else None
    ctx.setup_done()
    probe.start()
    t_start = time.time()
    if recorder is not None:
        capture.trace_from = t_start + tr["trace_at"] * seconds
    if open_loop:
        seq = _open_loop(frames, distinct, warm, n_win, tr["rate"], fps,
                         marks)
    else:
        seq = _closed_loop(frames, distinct, warm, seconds, fps, marks)
    if spans is not None:
        with profiling.recording(spans):
            results = runner.run(seq, initial_state=state)
    else:
        results = runner.run(seq, initial_state=state)
    probe.stop()
    if recorder is not None and not capture.trace_done:
        if capture.trace_first is not None:
            recorder.stop(len(capture.order) - capture.trace_first)
            capture.trace_done = True
    t0 = marks["t0"]
    end = t0 + seconds
    pipeline.detect_step = capture.real
    grab.restore()
    if recorder is not None:
        recorder.restore()

    out = {}
    harvested = {int(round(r.time * fps)): r.harvest_wall for r in results}
    if open_loop:
        lat = [(harvested[j] - (t0 + (j - warm) / tr["rate"])) * 1e3
               for j in range(warm, warm + n_win) if j in harvested]
        miss = 1e3 * 10 * seconds
        offered = n_win
        out["latency_p95_ms"] = stats.latency_quantile(lat, offered, 0.95,
                                                       miss)
        bench.log(f"latency: p95 {out['latency_p95_ms']!r} ms over "
                  f"{offered} pairs offered, {len(lat)} came back")
    else:
        offered = marks["offered"]
        done = sum(1 for wall in harvested.values() if t0 <= wall <= end)
        out["pairs_per_s"] = stats.rate(done, seconds)
        bench.log(f"pairs: {done} came back inside the {seconds} s window, "
                  f"{offered} offered, {len(harvested)} came back in all")
    bench.log(f"host: {probe.summary()}")
    failed = offered - sum(1 for j in harvested if warm <= j < warm + offered)
    memory_peak = bench.memory_peak(dev)

    view = RaftView("serve")
    if recorder is not None and capture.trace_first is not None:
        tf = capture.trace_first - window_first
        view.trace = trace.summarize(recorder)
        cut = capture.trace_start_wall
        traced = capture.order[capture.trace_first:
                               capture.trace_first + recorder.units]
        read_spans(view, recorder, spans, traced)
    else:
        tf, cut = len(capture.order) - window_first, end
    for stage in ("dispatch", "harvest"):
        vals = runner.timer.samples.get(stage, [])
        view.stage_ms[stage] = [1e3 * v for v in vals[:tf]]
    view.flops_per_unit = flops_raft.from_config(
        cfg["flownet"], 1, h // config.flow_input_scale,
        w // config.flow_input_scale)
    if not open_loop:
        view.units_completed = sum(1 for wall in harvested.values()
                                   if t0 <= wall <= min(cut, end))
        view.units_seconds = min(cut, end) - t0

    kept = capture.kept
    del runner, model, results, state
    bench.reset_peak(dev)
    records = []
    for j in sorted(kept):
        pos, st_in, left, right, t, o, st_out = kept[j]
        prev_j = capture.order[pos - 1] if pos > 0 else None
        prev_img = (frames[scene_mod.playback(distinct, prev_j), 0]
                    if prev_j is not None else None)
        records.append(dict(state_in=judge_serve.state_dict_of(st_in),
                            state_out=judge_serve.state_dict_of(st_out),
                            left=left, right=right, t=t,
                            outputs=judge_serve.outputs_of(o),
                            prev_image=prev_img,
                            lookup=grab.features
                            if j == capture.grab_pair else None))
    del kept
    numbers = judge_records(ctx, cfg, state_dict, records)
    return dict(attempted=offered, failed=failed, e2e=out, view=view,
                checks=judge_serve.checks(numbers, LIMITS), numbers=numbers,
                memory_peak=memory_peak, judged=len(records),
                records=records if getattr(ctx, "keep_records", False)
                else None, state_dict=state_dict)


def read_spans(view, recorder, spans, traced) -> None:
    """The traced part's device ms a pair by span, onto ``view``, and its
    counters and stages a pair, logged: its pairs' spans placed on the
    profiler's clock (``profiling.trace_offset_ns``) and their device
    operations found by correlation id (``profiling.device_ms_by_span``).
    Nothing where the part recorded no span."""
    from moving_object_detector_tpu_torch.utils import profiling

    units = set(traced)
    every = spans.spans()
    mine = [s for s in every if s.unit in units]
    if not mine or not units:
        return
    path = os.path.join(bench.ROOT, ".portbench_cache",
                        f"raft_trace_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    recorder.prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            chrome = json.load(f)
    finally:
        os.remove(path)
    offset = profiling.trace_offset_ns(mine, chrome)
    if offset is None:
        return
    by = profiling.device_ms_by_span(mine, chrome, offset)
    n = len(units)

    def device(name):
        return sum(ms for (s, u), ms in by.items() if s == name) / n

    for name in SPANS:
        if any(s.name == name for s in mine):
            view.span_device_ms[name] = device(name)
    counters = {}
    for (name, unit), k in spans.counters.items():
        if unit in units:
            counters[name] = counters.get(name, 0) + k / n
    host = {name: sum(ms for u, ms in profiling.per_unit_ms(
        every, name, self_time=True).items() if u in units) / n
        for name in SPANS + STAGES}
    bench.log(f"device ms a pair by span: {view.span_device_ms}; counters "
              f"a pair: {counters}; stages' host (self) / device ms a "
              f"pair: " + str({k: (host[k], device(k)) for k in host}))


def reference_setup(cfg: dict, state: dict, device, **net_changes):
    """The reference's net (the program's weights), stereo rig and
    configuration; ``net_changes`` alter the net's configuration (the
    controls)."""
    from ..reference import config as rconfig, raft, types

    fields = dict(flownet_group(cfg), **net_changes)
    fields.pop("corr_backend", None)
    net = raft.raft_from_state(state, raft.RAFTConfig(**fields), device)
    h, w = cfg["height"], cfg["width"]
    fx, baseline = cfg["camera"]["fx"], cfg["camera"]["baseline"]
    stereo = types.StereoModel.create(fx, fx, w / 2.0, h / 2.0, baseline,
                                      device=device)
    config = configs.pipeline_config(rconfig, {k: v for k, v in cfg.items()
                                               if k != "flownet"})
    return net, stereo, config


def first_lookup(net, prev_img, now_img):
    """The reference's first lookup (``reference.raft.RAFT.first_lookup``)
    of a pair's images, prepared as the serving step prepares them."""
    import torch

    from ..reference.step import _adapt_flow_channels

    c = net.config.in_channels
    mult = 2 ** len(net.config.feature_channels)

    def prep(img):
        x = _adapt_flow_channels(img, c).permute(2, 0, 1)[None]
        hh, ww = x.shape[-2:]
        return torch.nn.functional.pad(
            x, (0, (-ww) % mult, 0, (-hh) % mult), mode="replicate")

    with torch.no_grad():
        return net.first_lookup(prep(prev_img), prep(now_img))


def lookup_gap(features, ref_features) -> float:
    """Mean absolute gap of two lookups' features over the reference's
    mean magnitude."""
    d = (features.float() - ref_features.float()).abs().mean()
    return float(d / ref_features.float().abs().mean().clamp(min=1e-30))


def judge_records(ctx, cfg, state, records, net_changes=None) -> dict:
    """The sample's compared numbers against the reference, in the
    configuration's precisions, TF32 off; ``net_changes`` put a control
    (the reference with another configuration) in the program's place for
    the lookup's number (``control_raft.py``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not records:
        raise bench.BenchError("no sampled pair came back to be judged")
    net, stereo, config = reference_setup(cfg, state, ctx.device)
    per = [judge_serve.judge_frame(net, stereo, config, r) for r in records]
    for j, p in enumerate(per):
        bench.log(f"judged pair {j}: {p}")
    numbers = judge_serve.worst(per)
    rec = next((r for r in records if r.get("lookup") is not None), None)
    if rec is None:
        raise bench.BenchError("the first sampled pair's lookup was not "
                               "caught")
    prev = rec["state_in"]["prev_left"]
    ref = first_lookup(net, prev, rec["left"])
    mine = rec["lookup"]
    if net_changes:
        ctl, _, _ = reference_setup(cfg, state, ctx.device, **net_changes)
        mine = first_lookup(ctl, prev, rec["left"])
    numbers["raft_lookup_gap"] = lookup_gap(mine, ref)
    return numbers
