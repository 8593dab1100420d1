"""Whether the training step is right: two stretches of three steps of
the one train state against the plain reference (``portbench/
reference/``), which computes in the precisions the configuration states
(the net's convolutions in its ``dtype``, the rest in f32 with TF32 off).

The first stretch is set-up's first three steps: the reference loads its
own copy of the net from the same weight archive, makes the batches again
from the seed with its copy of the scene generator, on the same card, and
trains for the same steps with the same loss, clip and AdamW. The second
is three steps of the window, across a boundary between two of its
chunks: the reference starts from the parameters and AdamW state the
program began them with (it cannot follow hundreds of steps of its own
without the two drifting apart), its generator moved past the batches
before; the first stretch checks that start by itself.

Compared, for each stretch (the window's named ``window_...``): the
batches the program trained on; each step's loss; the norm of each
parameter's gradient as AdamW got it at the first step (worked out from
the optimizer's first moment before and after it); the norm of each
parameter's change after the three steps. The two norms are taken by the
worst parameter, as the gap between the program's norm and the
reference's over the larger of the reference's norm of that parameter
and of the median parameter. The change leaves out parameters whose
reference gradient is under a thousandth of the median parameter's:
Adam moves those by round-off alone (a bias under a softmax, the finest
estimator's unused up-sampling head).
"""

from __future__ import annotations

import dataclasses
import os
import statistics

import torch

from . import bench

# Each compared number's limit; the readings each was set from are in
# PERF.md.
LIMITS = {
    "batch_differ": 0,
    "loss_gap": 0.015,
    "grad_norm_gap": 0.2,
    "update_norm_gap": 0.12,
    "window_batch_differ": 0,
    "window_loss_gap": 0.015,
    "window_grad_norm_gap": 0.05,
    "window_update_norm_gap": 0.12,
}
NEGLIGIBLE_GRAD = 1e-3  # of the median parameter's gradient norm


def norm_gaps(prog: list, ref: list, keep=None) -> list:
    """[(gap, parameter index)] of the per-parameter norms."""
    pn = [float(torch.linalg.vector_norm(p.float())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.float())) for r in ref]
    idx = [i for i in range(len(rn)) if keep is None or keep[i]]
    med = statistics.median(rn[i] for i in idx)
    return [(abs(pn[i] - rn[i]) / max(rn[i], med), i) for i in idx]


def norm_gap(prog: list, ref: list, keep=None) -> tuple:
    """(worst gap, its parameter index) of the per-parameter norms."""
    return max(norm_gaps(prog, ref, keep))


def skip_batches(gen, n: int, cfg: dict, channels: int) -> None:
    """Move ``gen`` past ``n`` batches of the configuration: the draws of
    ``data_synth.generate_batch`` without the rendering."""
    from ..reference import data_synth

    d, b, h, w = cfg["data"], cfg["batch"], cfg["height"], cfg["width"]
    n_ds = int(round(b * float(d["downsample_frac"])))
    for _ in range(n):
        for rows, s in ((b - n_ds, 1), (n_ds, 2)):
            if rows > 0:
                data_synth.draw_pair(gen, rows, s * h, s * w, d["n_objects"],
                                     d["real_frac"], d["local_motion_frac"],
                                     channels)


def reference_steps(cfg: dict, seed: int, steps: int, dtype: str, device,
                    loss_rows: int | None = None, start: dict | None = None):
    """The reference's ``steps`` train steps: (batches, losses, first
    gradients, parameters before, after). From the configuration's
    weights, or with ``start`` (``first``, ``params0``, ``opt0``: the step,
    parameters and AdamW state a program's kept steps began from) from
    there, its batches from the seed's generator moved past the ``first``
    batches before. ``loss_rows`` trains on the first rows of each batch
    alone (a fault the check must catch)."""
    from ..reference import checkpoint, data_synth, trainer

    net = checkpoint.load_flow_weights(
        os.path.join(bench.ROOT, cfg["weights"]), dtype, device)
    net.train()
    opt = cfg["optimizer"]
    state, tx = trainer.create_train_state(
        net, learning_rate=opt["learning_rate"], total_steps=None)
    tx = dataclasses.replace(tx, max_norm=opt["max_norm"],
                             weight_decay=opt["weight_decay"])
    for group in state.optimizer.param_groups:
        group["weight_decay"] = opt["weight_decay"]
        group["betas"] = tuple(opt["betas"])
        group["eps"] = opt["eps"]
    data = cfg["data"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if start is not None:
        with torch.no_grad():
            for p, v in zip(net.parameters(), start["params0"]):
                p.copy_(v)
        for p, s in zip(net.parameters(), start["opt0"]):
            if s:
                state.optimizer.state[p] = {
                    k: v.clone() if torch.is_tensor(v) else v
                    for k, v in s.items()}
        state.step = start["first"]
        skip_batches(gen, start["first"], cfg, net.config.in_channels)
    params0 = [p.detach().clone() for p in net.parameters()]
    batches, losses, grads1 = [], [], None
    for i in range(steps):
        batch = data_synth.generate_batch(
            gen, cfg["batch"], cfg["height"], cfg["width"],
            data["n_objects"], data["max_shift"], data["bg_max_shift"],
            downsample_frac=data["downsample_frac"],
            real_frac=data["real_frac"],
            local_motion_frac=data["local_motion_frac"],
            channels=net.config.in_channels)
        batches.append(batch)
        rows = slice(0, loss_rows)
        loss, _ = trainer.flow_loss(net, batch["img1"][rows],
                                    batch["img2"][rows], batch["flow"][rows],
                                    motion_contrast=data["motion_contrast"])
        params = list(net.parameters())
        grads = trainer._grads(loss, params)
        trainer.clip_by_global_norm(grads, tx.max_norm)
        if i == 0:
            grads1 = [g.detach().clone() for g in grads]
        trainer._apply(state, tx, params, grads)
        losses.append(float(loss.detach()))
    after = [p.detach().clone() for p in net.parameters()]
    return batches, losses, grads1, params0, after


def plain_gaps(prog: list, ref: list, keep=None) -> list:
    """[(gap, parameter index)] of the per-parameter norms over the
    reference's norm of that parameter alone (read, not compared: it
    swings on the parameters whose reference norm is near 0)."""
    pn = [float(torch.linalg.vector_norm(p.float())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.float())) for r in ref]
    return [(abs(pn[i] - rn[i]) / max(rn[i], 1e-30), i)
            for i in range(len(rn)) if keep is None or keep[i]]


def numbers(prog: dict, ref: tuple, prefix: str = "") -> dict:
    """The compared numbers of the program's kept steps ``prog`` (keys
    batches, losses, grads1, params0, params_k) against ``ref``, their
    names after ``prefix``; beside them, read and not compared, the
    median parameter's gaps, the gaps over each parameter's own norm
    (``..._plain``) and the parameters each worst gap was on."""
    batches, losses, grads1, params0, after = ref
    n = {}
    n["batch_differ"] = sum(
        int((pb[k] != rb[k]).sum()) for pb, rb in zip(prog["batches"],
                                                      batches)
        for k in ("img1", "img2", "flow"))
    gaps = [abs(float(p) - r) / abs(r) for p, r in zip(prog["losses"],
                                                         losses)]
    n["loss_gap"] = max(gaps)
    n["loss_gap_first"] = gaps[0]
    g = norm_gaps(prog["grads1"], grads1)
    n["grad_norm_gap"], n["grad_norm_gap_at"] = max(g)
    n["grad_norm_gap_median"] = statistics.median(x for x, _ in g)
    n["grad_norm_gap_plain"], n["grad_norm_gap_plain_at"] = max(
        plain_gaps(prog["grads1"], grads1))
    gnorm = [float(torch.linalg.vector_norm(g)) for g in grads1]
    med = statistics.median(gnorm)
    keep = [g >= NEGLIGIBLE_GRAD * med for g in gnorm]
    prog_up = [a - b for a, b in zip(prog["params_k"], prog["params0"])]
    ref_up = [a - b for a, b in zip(after, params0)]
    ups = norm_gaps(prog_up, ref_up, keep)
    n["update_norm_gap"], n["update_norm_gap_at"] = max(ups)
    n["update_norm_gap_median"] = statistics.median(x for x, _ in ups)
    n["update_norm_gap_plain"], n["update_norm_gap_plain_at"] = max(
        plain_gaps(prog_up, ref_up, keep))
    n["left_out"] = len(keep) - sum(keep)
    return {prefix + k: v for k, v in n.items()}


def checks(n: dict, limits: dict = LIMITS) -> list:
    return [dict(name=k, value=n[k], limit=limits[k], ok=bool(n[k] <= limits[k]))
            for k in limits]


def judge(cfg, seed, kept, names, device) -> dict:
    """The numbers of the set-up's first steps (the reference from the
    configuration's weights) and of the window's kept steps (the
    reference from the state the program began them with), the latter
    named ``window_...``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = cfg["flownet"]["dtype"]
    n = {}
    for part, prefix in (("start", ""), ("window", "window_")):
        k = kept[part]
        ref = reference_steps(cfg, seed, len(k["losses"]), dtype, device,
                              start=k if part == "window" else None)
        n.update(numbers(k, ref, prefix))
    n["window_first"] = kept["window"]["first"]
    bench.log(f"train judge: {n}; worst gradient "
              f"{names[n['grad_norm_gap_at']]}, in the window "
              f"{names[n['window_grad_norm_gap_at']]}")
    return n
