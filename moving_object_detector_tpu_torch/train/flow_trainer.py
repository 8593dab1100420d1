"""Flow-network training: multi-scale supervised endpoint error, AdamW,
the JAX package's ``train/flow_trainer.py`` in PyTorch.

The same step as the reference: PWC-Net's multi-scale EPE objective
(optionally up-weighting independently moving pixels), the global-norm
clip, AdamW with weight decay 4e-4 and, with ``total_steps``, a linear
warm-up into a cosine decay. The clip and the schedule are written out
with Optax's arithmetic (``clip_by_global_norm`` scales by max_norm /
norm only when the norm reaches max_norm; the schedule is evaluated at
the update count before it is incremented, so the first step has lr 0);
``torch.optim.AdamW`` has Optax's ``adamw`` arithmetic. PyTorch updates
the parameters in place where the JAX step returns new ones.

On CUDA tensors the correlation's forward and backward are the
hand-written kernels (``ops/flow_corr_cuda.py``) unless the net's
``corr_backend`` says "xla". ``make_sharded_train_step`` runs the step
over a ``torch.distributed`` (data, model) mesh; ``make_chunked_train_step``
runs ``chunk`` steps on batches made on the device, without a host sync.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.pwc_net import PWCNet
from ..ops import flow_ops
from ..utils import profiling

# Per-level supervision weights, finest (the level-2 estimate) first: the
# standard PWC-Net schedule shape.
LEVEL_WEIGHTS = (0.32, 0.08, 0.02, 0.01, 0.005)
POOL_SEED = 17  # pool > 0: the batch of step s is made from (17, s % pool)


@dataclasses.dataclass(frozen=True)
class FlowOptimizer:
    """The gradient transformation's constants (the JAX step's ``tx``):
    the global-norm clip, AdamW's decay and the learning-rate schedule."""

    learning_rate: float = 1e-4
    total_steps: int | None = None
    warmup_steps: int = 500
    max_norm: float = 1.0
    weight_decay: float = 4e-4

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (0 for the first): constant
        without ``total_steps``, else Optax's
        ``warmup_cosine_decay_schedule(0, lr, warmup, total, 0.02 lr)``."""
        peak = self.learning_rate
        if self.total_steps is None:
            return peak
        warmup = self.warmup_steps
        decay = self.total_steps - warmup
        if decay <= 0:
            raise ValueError(f"total_steps {self.total_steps} leaves no "
                             f"decay after {warmup} warm-up steps")
        if count < warmup:
            return (0.0 - peak) * (1.0 - count / warmup) + peak
        alpha = 0.0 if peak == 0.0 else (peak * 0.02) / peak
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)


@dataclasses.dataclass
class FlowTrainState:
    """The net (its parameters, updated in place), the AdamW state and the
    number of updates made."""

    model: PWCNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: PWCNet, learning_rate: float = 1e-4,
                       total_steps: int | None = None,
                       warmup_steps: int = 500):
    """(state, tx) for training ``model`` from its current parameters
    (``models.pwc_net.init_pwc_params`` draws fresh ones). ``total_steps``
    switches the constant LR to a linear warm-up of min(warmup_steps,
    total_steps // 10 + 1) steps into a cosine decay to 0.02 x."""
    warmup = (min(warmup_steps, total_steps // 10 + 1)
              if total_steps is not None else warmup_steps)
    tx = FlowOptimizer(learning_rate, total_steps, warmup)
    optimizer = torch.optim.AdamW(model.parameters(), lr=tx.lr(0),
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=tx.weight_decay)
    return FlowTrainState(model, optimizer, 0), tx


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last dimension: the mean of the two middle
    values for an even count (``torch.median`` takes the lower one)."""
    s = x.sort(dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) / 2


def motion_contrast_weights(gt_flow: torch.Tensor, strength: float,
                            sat_px: float = 4.0, dilate: int = 4
                            ) -> torch.Tensor:
    """(B, H, W) loss weights up-weighting independently moving pixels:
    1 + strength * min(dev / sat_px, 1), dev the distance of a pixel's
    ground-truth flow (B, 2, H, W) from the image's median flow (the
    background), max-pooled over a (2 dilate + 1) window so the background
    bordering a mover carries its weight too, normalised to mean 1 per
    image."""
    b = gt_flow.shape[0]
    bg = _median(gt_flow.flatten(2))[:, :, None, None]
    dev = torch.sqrt(torch.sum((gt_flow - bg) ** 2, dim=1) + 1e-8)
    raw = 1.0 + strength * torch.clamp_max(dev / sat_px, 1.0)
    if dilate > 0:
        raw = F.max_pool2d(raw[:, None], 2 * dilate + 1, stride=1,
                           padding=dilate)[:, 0]
    return raw / raw.reshape(b, -1).mean(-1)[:, None, None]


def flow_loss(model: PWCNet, img1, img2, gt_flow,
              motion_contrast: float = 0.0):
    """(loss, full-resolution EPE) of ``model`` on (B, C, H, W) images with
    (B, 2, H, W) ground truth: the level weights times each level's mean
    EPE against the truth resized to it, plus 0.1 x the full-resolution
    term. ``motion_contrast`` > 0 weights pixels by
    ``motion_contrast_weights``; 0 is the uniform loss."""
    full, levels = model(img1, img2)
    wmap = (motion_contrast_weights(gt_flow, motion_contrast)
            if motion_contrast > 0 else None)
    total = torch.zeros((), dtype=torch.float32, device=full.device)
    for i, lvl_flow in enumerate(levels):
        w = LEVEL_WEIGHTS[min(i, len(LEVEL_WEIGHTS) - 1)]
        lh, lw = lvl_flow.shape[2], lvl_flow.shape[3]
        scale = lw / gt_flow.shape[3]
        gt = flow_ops.resize_bilinear(gt_flow, (lh, lw)) * scale
        epe = torch.sqrt(torch.sum((lvl_flow - gt) ** 2, dim=1) + 1e-8)
        if wmap is not None:
            lvl_w = flow_ops.resize_bilinear(wmap[:, None], (lh, lw))[:, 0]
            # Back to mean 1 per image: the resize drifts the mean.
            lvl_w = lvl_w / lvl_w.mean(dim=(1, 2), keepdim=True)
            epe = epe * lvl_w
        total = total + w * epe.mean()
    full_epe_map = torch.sqrt(torch.sum((full - gt_flow) ** 2, dim=1) + 1e-8)
    full_epe = full_epe_map.mean()
    full_term = (full_epe_map * wmap).mean() if wmap is not None else full_epe
    return total + 0.1 * full_term, full_epe


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Optax's rule, in place: every gradient becomes (g / norm) * max_norm
    when the global norm reaches ``max_norm``, and stays as it is below.
    Returns the norm before clipping (a device scalar: no sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    divisor = torch.where(norm < max_norm, 1.0, norm)
    for g in grads:
        g.div_(divisor).mul_(max_norm)
    return norm


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d params, zeros for a parameter the loss does not reach
    (the finest estimator's up-sampling head): JAX's gradient is zero
    there too, and AdamW's weight decay still applies to it."""
    return list(torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True))


def _apply(state, tx: FlowOptimizer, params, grads) -> None:
    """One AdamW update of ``params`` by ``grads`` at the scheduled rate
    of ``state.step``; counts it."""
    for p, g in zip(params, grads):
        p.grad = g
    for group in state.optimizer.param_groups:
        group["lr"] = tx.lr(state.step)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


def train_step(model: PWCNet, tx: FlowOptimizer, state: FlowTrainState,
               batch: dict, motion_contrast: float = 0.0):
    """One update on ``batch`` = dict(img1, img2, flow), NCHW. Returns the
    state (updated in place) and device scalars {"loss", "epe",
    "grad_norm"}: nothing here waits for the card. While a span recorder
    is active (``utils/profiling.py``) the loss, its gradients and the
    clip with the update are spans ``forward``, ``backward`` and
    ``optimizer`` of unit ``state.step``."""
    profiling.set_unit(state.step)
    with profiling.span("forward"):
        loss, epe = flow_loss(model, batch["img1"], batch["img2"],
                              batch["flow"], motion_contrast=motion_contrast)
    params = list(model.parameters())
    with profiling.span("backward"):
        grads = _grads(loss, params)
    with profiling.span("optimizer"):
        norm = clip_by_global_norm(grads, tx.max_norm)
        _apply(state, tx, params, grads)
    return state, {"loss": loss.detach(), "epe": epe.detach(),
                   "grad_norm": norm}


# ---------------------------------------------------------------------------
# Sharded over a torch.distributed (data, model) mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedTrainState:
    """A rank's part of a sharded train state: each parameter's shard as
    ``flow_param_sharding`` places it (a DTensor over the mesh), the AdamW
    state of those shards, the update count, and the full-width net the
    step runs (its parameters gathered before every step)."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int
    model: PWCNet


def make_sharded_train_step(model: PWCNet, tx: FlowOptimizer, mesh,
                            state: FlowTrainState):
    """The train step over a (data, model) ``DeviceMesh`` of the default
    process group: (step_fn, sharded_state).

    The global batch splits over "data" (each rank keeps its slice); the
    parameters and their AdamW state are placed by
    ``parallel.mesh.flow_param_sharding`` (conv output channels over
    "model"). A step gathers the full parameters over "model", runs
    forward and backward on the rank's slice, averages the gradients over
    "data", clips by the global norm and updates the rank's shards: the
    same update as ``train_step`` on the whole batch in one process.
    ``step_fn(sharded_state, batch)`` takes the global batch and returns
    the state and the batch's metrics (averaged over "data")."""
    from torch.distributed.tensor import distribute_tensor

    from ..parallel.mesh import flow_param_sharding

    placements = flow_param_sharding(mesh, model.named_parameters())
    params = {name: distribute_tensor(p.detach().clone(), mesh,
                                      placements[name])
              for name, p in model.named_parameters()}
    with torch.no_grad():  # the shards' own storage, updated in place
        local = [params[name].to_local()
                 for name, _ in model.named_parameters()]
    defaults = state.optimizer.defaults
    optimizer = torch.optim.AdamW(
        local, lr=tx.lr(state.step), betas=defaults["betas"],
        eps=defaults["eps"], weight_decay=defaults["weight_decay"])
    sharded = ShardedTrainState(params, optimizer, state.step, model)
    data_group = mesh.get_group("data")
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    i_data = mesh.get_local_rank("data")

    def step_fn(st: ShardedTrainState, batch: dict,
                motion_contrast: float = 0.0):
        net = st.model
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(st.params[name].full_tensor())
        chunk = batch["img1"].shape[0] // n_data
        part = {k: v[i_data * chunk:(i_data + 1) * chunk]
                for k, v in batch.items()}
        loss, epe = flow_loss(net, part["img1"], part["img2"], part["flow"],
                              motion_contrast=motion_contrast)
        names = [name for name, _ in net.named_parameters()]
        grads = _grads(loss, list(net.parameters()))
        metrics = torch.stack([loss.detach(), epe.detach()])
        for g in grads + [metrics]:
            dist.all_reduce(g, group=data_group)
            g.div_(n_data)
        norm = clip_by_global_norm(grads, tx.max_norm)
        shards = [distribute_tensor(g, mesh, st.params[n].placements,
                                    src_data_rank=None).to_local()
                  for n, g in zip(names, grads)]
        _apply(st, tx, st.optimizer.param_groups[0]["params"], shards)
        return st, {"loss": metrics[0], "epe": metrics[1], "grad_norm": norm}

    return step_fn, sharded


def full_params(sharded: ShardedTrainState) -> dict:
    """The whole parameters of a sharded state (a collective: every rank
    calls it), by the net's parameter names."""
    return {name: p.full_tensor() for name, p in sharded.params.items()}


# ---------------------------------------------------------------------------
# Chunks of steps on batches made on the device
# ---------------------------------------------------------------------------


def make_chunked_train_step(model: PWCNet, tx: FlowOptimizer,
                            state: FlowTrainState, height: int, width: int,
                            batch: int, chunk: int, n_objects: int = 4,
                            max_shift: float = 24.0,
                            bg_max_shift: float = 10.0, pool: int = 0,
                            downsample_frac: float = 0.0,
                            local_motion_frac: float = 0.0,
                            real_frac: float = 0.0,
                            motion_contrast: float = 0.0, mesh=None,
                            seed: int = 1):
    """``chunk`` train steps a call, each on a batch made on the device by
    ``train.data_synth.generate_batch``: (chunk_fn, state), with
    ``chunk_fn(state) -> (state, metrics)`` and the metrics the chunk's
    means as device scalars, to be read once a chunk. Nothing inside a
    chunk waits for the card. Each batch's making is span ``batch`` of
    the step it is for (``utils/profiling.py``).

    Batches come from one generator on the net's device seeded with
    ``seed``, drawn on from chunk to chunk. ``pool`` > 0 draws the batch
    of step s from a generator seeded with (17, s % pool) instead: a
    fixed pool of scenes. With a ``mesh`` every rank makes the same
    global batch and the step is ``make_sharded_train_step``'s; the state
    returned is then the sharded one."""
    from .data_synth import generate_batch

    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if mesh is not None:
        step, state = make_sharded_train_step(model, tx, mesh, state)
    else:
        def step(st, data, motion_contrast):
            return train_step(model, tx, st, data, motion_contrast)

    def chunk_fn(st):
        sums = None
        for _ in range(chunk):
            if pool > 0:
                gen.manual_seed((POOL_SEED << 32) + st.step % pool)
            with profiling.span("batch", unit=st.step):
                data = generate_batch(
                    gen, batch, height, width, n_objects, max_shift,
                    bg_max_shift, downsample_frac=downsample_frac,
                    real_frac=real_frac, local_motion_frac=local_motion_frac,
                    channels=model.config.in_channels)
            st, m = step(st, data, motion_contrast)
            m = torch.stack([m["loss"], m["epe"]])
            sums = m if sums is None else sums + m
        means = sums / chunk
        return st, {"loss": means[0], "epe": means[1]}

    return chunk_fn, state


def synthetic_flow_batch(rng: np.random.Generator, batch: int, height: int,
                         width: int) -> dict:
    """Random-texture pairs with a constant integer flow per sample (u in
    -3..3, v in -2..2), made with numpy from ``rng`` exactly as the JAX
    package makes them; returned as CPU tensors, NCHW."""
    img1 = rng.uniform(0, 1, (batch, height, width, 1)).astype(np.float32)
    flow = np.zeros((batch, height, width, 2), np.float32)
    img2 = np.empty_like(img1)
    for b in range(batch):
        du = int(rng.integers(-3, 4))
        dv = int(rng.integers(-2, 3))
        img2[b, ..., 0] = np.roll(np.roll(img1[b, ..., 0], -du, axis=1),
                                  -dv, axis=0)
        flow[b, ..., 0] = du
        flow[b, ..., 1] = dv
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in (("img1", img1), ("img2", img2), ("flow", flow))}
