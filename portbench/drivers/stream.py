"""Serving cells: stereo pairs through ``PipelineRunner.run``, the loop
users run, into ``pipeline.detect_step``.

The traffic file says how pairs arrive. ``"open"``: a camera offers pair
i at ``t0 + i / rate`` whether or not the port keeps up (the runner's
feeder thread runs the schedule, which sleeps until each pair is due and
never waits for the port); the window holds ``rate * seconds`` pairs.
``"closed"``: a recorded drive replayed, the next pair offered as soon
as the ring has room, for ``seconds``. The pairs are a drive of the
scene (``traffic/scene.py``) rendered in set-up from the seed and played
forward and then back; scene time advances ``1 / fps`` a pair.

End-to-end: ``latency_p95_ms`` (open): the 95th percentile over every
pair offered of the time from the pair's due time to its ``FrameResult``
on the host (``harvest_wall``, the same ``time.time()`` clock), a pair
that never came back counting above every latency; ``pairs_per_s``
(closed): the pairs whose results reached the host inside the window
over the window.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ..core import bench, configs, flops, host, judge_serve, stats, trace
from ..traffic import scene as scene_mod


class _Capture:
    """Wraps ``pipeline.detect_step``: logs the sequence index of every
    pair the runner processes, keeps the sampled pairs' inputs, outputs
    and states for the judge, and starts and stops the traced part."""

    def __init__(self, real, fps: float, recorder=None):
        self.real = real
        self.fps = fps
        self.sample = set()
        self.kept = {}
        self.order = []
        self.recorder = recorder
        self.trace_from = None  # wall time at which the traced part starts
        self.trace_pairs = 0
        self.trace_first = None  # position in ``order`` of its first pair
        self.trace_start_wall = None
        self.trace_done = False

    def index(self, t) -> int:
        return int(round(float(t) * self.fps))

    def __call__(self, flow_model, state, left, right, t, *args, **kwargs):
        j = self.index(t)
        rec = self.recorder
        if rec is not None and not self.trace_done:
            if (self.trace_first is None and self.trace_from is not None
                    and time.time() >= self.trace_from):
                self.trace_first = len(self.order)
                self.trace_start_wall = time.time()
                rec.start()
            elif (self.trace_first is not None
                  and len(self.order) - self.trace_first >= self.trace_pairs):
                rec.stop(self.trace_pairs)
                self.trace_done = True
        self.order.append(j)
        new_state, out = self.real(flow_model, state, left, right, t, *args,
                                   **kwargs)
        if j in self.sample:
            self.kept[j] = (len(self.order) - 1, state, left, right, t, out,
                            new_state)
        return new_state, out


def _open_loop(frames, distinct, j0, n, rate, fps, marks):
    """Pairs j0 .. j0 + n - 1 on the camera's schedule; ``marks`` gets
    the schedule's start and how late each pair was offered."""
    t0 = time.time()
    marks["t0"] = t0
    late = marks["late"]
    for i in range(n):
        due = t0 + i / rate
        wait = due - time.time()
        if wait > 0:
            time.sleep(wait)
        late.append(time.time() - due)
        j = j0 + i
        k = scene_mod.playback(distinct, j)
        yield frames[k, 0], frames[k, 1], j / fps


def _closed_loop(frames, distinct, j0, seconds, fps, marks):
    """Pairs from j0 on, each as soon as the runner takes it, until the
    window has passed."""
    t0 = time.time()
    marks["t0"] = t0
    j = j0
    while time.time() < t0 + seconds:
        k = scene_mod.playback(distinct, j)
        marks["offered"] = j - j0 + 1
        yield frames[k, 0], frames[k, 1], j / fps
        j += 1


def _paced(frames, distinct, j0, n, fps, gap_s):
    for j in range(j0, j0 + n):
        k = scene_mod.playback(distinct, j)
        yield frames[k, 0], frames[k, 1], j / fps
        time.sleep(gap_s)


def run(ctx) -> dict:
    from moving_object_detector_tpu_torch import StereoModel
    from moving_object_detector_tpu_torch import config as pconfig
    from moving_object_detector_tpu_torch import pipeline
    from moving_object_detector_tpu_torch.io.runner import PipelineRunner
    from moving_object_detector_tpu_torch.utils.checkpoint import \
        load_flow_checkpoint
    from moving_object_detector_tpu_torch.utils.profiling import StageTimer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    h, w = cfg["height"], cfg["width"]
    fx, baseline = cfg["camera"]["fx"], cfg["camera"]["baseline"]
    config = configs.pipeline_config(pconfig, cfg)
    stereo = StereoModel.create(fx, fx, w / 2.0, h / 2.0, baseline,
                                device=dev)
    bench.build_kernels(dev)
    model, flow_cfg = load_flow_checkpoint(
        os.path.join(bench.ROOT, cfg["weights"]), config.flownet, device=dev)
    stated = configs.flownet_fields(cfg)
    got = {k: getattr(flow_cfg, k) for k in stated}
    if got != stated:
        raise bench.BenchError(f"the weights' net {got} is not the "
                               f"configuration's {stated}")
    config = dataclasses.replace(config, flownet=flow_cfg)

    sc = scene_mod.params(tr)
    frames = scene_mod.render(sc, h, w, fx, baseline, ctx.seed, dev)
    distinct, fps = sc["pairs"], sc["fps"]
    bench.reset_peak(dev)

    recorder = (trace.Recorder(bench.bound_modules(), dev) if ctx.trace
                else None)
    capture = _Capture(pipeline.detect_step, fps, recorder)
    pipeline.detect_step = capture  # the runner looks it up at each run()
    runner = PipelineRunner(config, stereo, model,
                            ring_capacity=tr["ring_capacity"],
                            drop_oldest=tr["drop_oldest"], device=dev)
    warm = tr["warmup_pairs"]
    open_loop = tr["arrival"] == "open"
    # Paced below the live rate in an open loop, so the ring of one keeps
    # every warm-up pair.
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
    marks = {"late": [], "offered": 0}
    if recorder is not None:
        capture.trace_pairs = tr["trace_pairs"]
    window_first = len(capture.order)  # the window's first pair in order
    probe = host.Probe(dev)
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
    results = runner.run(seq, initial_state=state)
    probe.stop()
    if recorder is not None and not capture.trace_done:
        if capture.trace_first is not None:
            recorder.stop(len(capture.order) - capture.trace_first)
            capture.trace_done = True
    t0 = marks["t0"]
    end = t0 + seconds
    pipeline.detect_step = capture.real
    if recorder is not None:
        recorder.restore()

    out = {}
    harvested = {int(round(r.time * fps)): r.harvest_wall for r in results}
    if open_loop:
        lat = [(harvested[j] - (t0 + (j - warm) / tr["rate"])) * 1e3
               for j in range(warm, warm + n_win) if j in harvested]
        miss = 1e3 * 10 * seconds  # above any latency a window can hold
        offered = n_win
        out["latency_p95_ms"] = stats.latency_quantile(lat, offered, 0.95,
                                                       miss)
        bench.log(f"latency: median {stats.latency_quantile(lat, offered, 0.5, miss)!r}"
                  f" ms, p95 {out['latency_p95_ms']!r} ms over {offered} "
                  f"pairs offered, {len(lat)} came back; the schedule "
                  f"offered pairs late by median "
                  f"{1e3 * float(np.median(marks['late']))!r} ms, at most "
                  f"{1e3 * max(marks['late'])!r} ms; ring dropped "
                  f"{runner.ring.dropped()}")
    else:
        offered = marks["offered"]
        done = sum(1 for wall in harvested.values() if t0 <= wall <= end)
        out["pairs_per_s"] = stats.rate(done, seconds)
        bench.log(f"pairs: {done} came back inside the {seconds} s window, "
                  f"{offered} offered, {len(harvested)} came back in all")
    bench.log(f"host: {probe.summary()}")
    failed = offered - sum(1 for j in harvested if warm <= j < warm + offered)
    memory_peak = bench.memory_peak(dev)

    view = RunView("serve")
    # The window's pairs dispatched before the traced part (the stage
    # timer holds the window's pairs alone, ``capture.order`` the warm-up's
    # too).
    if recorder is not None and capture.trace_first is not None:
        tf = capture.trace_first - window_first
        view.trace = trace.summarize(recorder)
        cut = capture.trace_start_wall
    else:
        tf, cut = len(capture.order) - window_first, end
    for stage in ("dispatch", "harvest"):
        vals = runner.timer.samples.get(stage, [])
        view.stage_ms[stage] = [1e3 * v for v in vals[:tf]]
    view.flops_per_unit = flops.from_config(
        cfg["flownet"], 1, h // config.flow_input_scale,
        w // config.flow_input_scale)
    if not open_loop:  # an offered rate fixes an open loop's share
        view.units_completed = sum(1 for wall in harvested.values()
                                   if t0 <= wall <= min(cut, end))
        view.units_seconds = min(cut, end) - t0

    # The judge, once the window has closed, the peak read and the
    # program's runner and net freed.
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
                            prev_image=prev_img))
    del kept
    numbers = judge_records(ctx, cfg, records)
    return dict(attempted=offered, failed=failed, e2e=out, view=view,
                checks=judge_serve.checks(numbers), numbers=numbers,
                memory_peak=memory_peak, judged=len(records),
                records=records if getattr(ctx, "keep_records", False)
                else None)


def reference_setup(cfg: dict, dtype: str, device):
    """The reference's net (its weights loaded from the same archive),
    stereo rig and configuration."""
    from ..reference import checkpoint, config as rconfig, types

    net = checkpoint.load_flow_weights(
        os.path.join(bench.ROOT, cfg["weights"]), dtype, device)
    h, w = cfg["height"], cfg["width"]
    fx, baseline = cfg["camera"]["fx"], cfg["camera"]["baseline"]
    stereo = types.StereoModel.create(fx, fx, w / 2.0, h / 2.0, baseline,
                                      device=device)
    config = configs.pipeline_config(rconfig, cfg, dtype=dtype)
    return net, stereo, config


def judge_records(ctx, cfg, records) -> dict:
    """The sample's compared numbers against the reference, which computes
    in the precisions the configuration states (the flow net in its
    ``dtype``, the rest in f32 with TF32 off)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not records:
        raise bench.BenchError("no sampled pair came back to be judged")
    net, stereo, config = reference_setup(cfg, cfg["flownet"]["dtype"],
                                          ctx.device)
    per = [judge_serve.judge_frame(net, stereo, config, r) for r in records]
    for j, p in enumerate(per):
        bench.log(f"judged pair {j}: {p}")
    return judge_serve.worst(per)


@dataclasses.dataclass
class RunView:
    """What the per-layer readers read of a run."""

    kind: str
    stage_ms: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    flops_per_unit: float = 0.0
    units_completed: int = 0
    units_seconds: float = 0.0
