"""Training cells: ``train/flow_trainer.py``'s ``make_chunked_train_step``
back to back, each chunk's steps on batches made on the card by
``train/data_synth.generate_batch``.

Set-up builds the one train state (the net from the configuration's
weights, AdamW) and its ``chunk_fn``, and runs its first chunk, whose
first three steps are kept for the judge; the window then calls the same
``chunk_fn`` on the same state until ``seconds`` have passed, reading
each chunk's metrics (the only host sync of a chunk). Three steps of the
window, across a boundary between two of its chunks drawn from the seed,
are kept for the judge too, with the state they started from. End-to-end:
``train_samples_per_s``, the samples of every step the window's chunks
completed over the window's wall time, from the start to the end of its
last chunk, the card synchronized at both ends.
"""

from __future__ import annotations

import dataclasses
import os
import time

from ..core import bench, configs, flops, host, judge_train, trace
from .stream import RunView


class _Kept:
    """What the judge reads of ``n`` steps from step ``first`` on: each
    step's batch and loss, the parameters and AdamW's state before the
    first, each parameter's gradient as AdamW got it at the first (worked
    out from its first moment before and after that step) and the
    parameters after the last."""

    def __init__(self, first: int, n: int):
        self.first, self.n = first, n
        self.batches, self.losses = [], []
        self.params0 = self.opt0 = self.grads1 = self.params_k = None
        self._m0 = None

    def before(self, i, model, st, data):
        import torch

        k = i - self.first
        if k < 0 or k > self.n:
            return
        params = list(model.parameters())
        if k == 0:
            self.params0 = [p.detach().clone() for p in params]
            self.opt0 = [{key: v.detach().clone() if torch.is_tensor(v)
                          else v for key, v in st.optimizer.state.get(
                              p, {}).items()} for p in params]
            self._m0 = [s.get("exp_avg") for s in self.opt0]
        if k == 1:  # m1 = beta1 m0 + (1 - beta1) g
            beta1 = st.optimizer.defaults["betas"][0]
            self.grads1 = [
                (st.optimizer.state[p]["exp_avg"].detach()
                 - (beta1 * m0 if m0 is not None else 0.0)) / (1.0 - beta1)
                if "exp_avg" in st.optimizer.state.get(p, {})
                else torch.zeros_like(p) for p, m0 in zip(params, self._m0)]
        if k == self.n:
            self.params_k = [p.detach().clone() for p in params]
            self._m0 = None
        else:
            self.batches.append({key: v.detach().clone()
                                 for key, v in data.items()})

    def after(self, i, m):
        if 0 <= i - self.first < self.n:
            self.losses.append(m["loss"].detach().clone())

    def complete(self) -> bool:
        return self.params_k is not None

    def as_dict(self) -> dict:
        return dict(first=self.first, batches=self.batches,
                    losses=self.losses, params0=self.params0, opt0=self.opt0,
                    grads1=self.grads1, params_k=self.params_k)


class _Steps:
    """Wraps ``flow_trainer.train_step``: keeps, for the judge, the first
    steps of set-up and the steps of the window from ``judge_at`` on, and
    starts and stops the traced part at given step counts."""

    def __init__(self, real, keep: int, judge_at: int, recorder=None):
        self.real = real
        self.start = _Kept(0, keep)
        self.window = _Kept(judge_at, keep)
        self.recorder = recorder
        self.trace_at = None  # first step of the traced part
        self.trace_steps = 0
        self.trace_done = False

    def __call__(self, model, tx, st, data, *args, **kwargs):
        i = st.step
        for kept in (self.start, self.window):
            kept.before(i, model, st, data)
        rec = self.recorder
        if rec is not None and self.trace_at is not None \
                and not self.trace_done:
            if i == self.trace_at:
                rec.start()
            elif i == self.trace_at + self.trace_steps:
                rec.stop(self.trace_steps)
                self.trace_done = True
        st, m = self.real(model, tx, st, data, *args, **kwargs)
        for kept in (self.start, self.window):
            kept.after(i, m)
        return st, m


def judged_steps(seed: int, chunk: int, chunks: int) -> int:
    """The first of the window's judged steps, drawn from the seed: the
    three steps cross the boundary between the window's chunk k and k + 1
    (k in 1 .. ``chunks``; chunk 0 is set-up's), one or two of them on
    either side."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, chunks + 1))
    return chunk * (k + 1) - 1 - int(rng.integers(0, 2))


def run(ctx) -> dict:
    from moving_object_detector_tpu_torch.config import FlowNetConfig
    from moving_object_detector_tpu_torch.train import flow_trainer
    from moving_object_detector_tpu_torch.utils.checkpoint import \
        load_flow_checkpoint

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    opt, data = cfg["optimizer"], cfg["data"]
    if opt["schedule"] != "constant" or opt["name"] != "adamw":
        raise bench.BenchError(f"optimizer {opt} is not the trainer's "
                               "AdamW at a constant rate")
    bench.build_kernels(dev)
    base = dataclasses.replace(FlowNetConfig(), **{
        k: v for k, v in configs.values(cfg["flownet"]).items()
        if k in ("dtype", "corr_backend")})
    model, flow_cfg = load_flow_checkpoint(
        os.path.join(bench.ROOT, cfg["weights"]), base, device=dev)
    stated = configs.flownet_fields(cfg)
    got = {k: getattr(flow_cfg, k) for k in stated}
    if got != stated:
        raise bench.BenchError(f"the weights' net {got} is not the "
                               f"configuration's {stated}")
    model.train()
    state, tx = flow_trainer.create_train_state(
        model, learning_rate=opt["learning_rate"], total_steps=None)
    tx = dataclasses.replace(tx, max_norm=opt["max_norm"],
                             weight_decay=opt["weight_decay"])
    for group in state.optimizer.param_groups:
        group["weight_decay"] = opt["weight_decay"]
        group["betas"] = tuple(opt["betas"])
        group["eps"] = opt["eps"]
    bench.reset_peak(dev)

    recorder = (trace.Recorder(bench.bound_modules(), dev) if ctx.trace
                else None)
    batch, chunk = cfg["batch"], cfg["chunk"]
    seed = ctx.seed % (1 << 63)
    steps = _Steps(flow_trainer.train_step, tr["check_steps"],
                   judged_steps(seed, chunk, tr["judge_chunks"]), recorder)
    flow_trainer.train_step = steps  # looked up by name at every step
    chunk_fn, state = flow_trainer.make_chunked_train_step(
        model, tx, state, cfg["height"], cfg["width"], batch, chunk,
        n_objects=data["n_objects"], max_shift=data["max_shift"],
        bg_max_shift=data["bg_max_shift"],
        downsample_frac=data["downsample_frac"],
        local_motion_frac=data["local_motion_frac"],
        real_frac=data["real_frac"],
        motion_contrast=data["motion_contrast"], seed=seed)
    state, m = chunk_fn(state)  # the first chunk: set-up, judged steps
    float(m["loss"])
    probe = host.Probe(dev)
    ctx.setup_done()

    seconds = ctx.seconds
    done = 0
    probe.start()
    t0 = time.perf_counter()
    chunk_ends = []
    while time.perf_counter() - t0 < seconds:
        if recorder is not None and steps.trace_at is None and (
                time.perf_counter() - t0 >= tr["trace_at"] * seconds):
            steps.trace_at = state.step + 1
            steps.trace_steps = tr["trace_steps"]
        state, m = chunk_fn(state)
        float(m["loss"])  # the chunk's one host read: it has finished
        done += chunk
        chunk_ends.append((time.perf_counter() - t0, state.step))
    bench.sync(dev)
    window = time.perf_counter() - t0
    probe.stop()
    flow_trainer.train_step = steps.real
    if recorder is not None:
        recorder.restore()
    memory_peak = bench.memory_peak(dev)
    samples = done * batch
    bench.log(f"train: {done} steps ({samples} samples) in {window!r} s, "
              f"chunks ending at {chunk_ends}")
    bench.log(f"host: {probe.summary()}")
    if not steps.window.complete():
        raise bench.BenchError(
            f"the window ended at step {state.step}, before its judged "
            f"steps {steps.window.first} to {steps.window.first + 2}")

    view = RunView("train")
    view.flops_per_unit = 3 * flops.from_config(
        cfg["flownet"], batch, cfg["height"], cfg["width"])
    # Outside the traced part: the chunks that ended before it began.
    first_traced = steps.trace_at if steps.trace_done else None
    before = [(s, n) for s, n in chunk_ends
              if first_traced is None or n < first_traced]
    if before:
        view.units_seconds = before[-1][0]
        view.units_completed = before[-1][1] - chunk_ends[0][1] + chunk
    if recorder is not None and steps.trace_done:
        view.trace = trace.summarize(recorder)

    kept = dict(start=steps.start.as_dict(), window=steps.window.as_dict())
    names = [n for n, _ in model.named_parameters()]
    del model, state, chunk_fn, steps
    bench.reset_peak(dev)
    numbers = judge_train.judge(cfg, seed, kept, names, dev)
    return dict(attempted=samples, failed=0,
                e2e={"train_samples_per_s": samples / window}, view=view,
                checks=judge_train.checks(numbers), numbers=numbers,
                memory_peak=memory_peak,
                judged=f"steps 0 to 2 and {kept['window']['first']} to "
                       f"{kept['window']['first'] + 2}",
                kept=kept if getattr(ctx, "keep_records", False) else None)
