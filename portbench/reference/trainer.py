"""Frozen copy of
``moving_object_detector_tpu_torch/train/flow_trainer.py`` at fc97bde
(without the sharded and chunked steps), the benchmark's plain
reference: it imports nothing of the port.

Flow-network training: multi-scale supervised endpoint error, AdamW,
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

import torch
import torch.nn.functional as F

from . import flow_ops
from .pwc_net import PWCNet

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
    "grad_norm"}: nothing here waits for the card."""
    loss, epe = flow_loss(model, batch["img1"], batch["img2"], batch["flow"],
                          motion_contrast=motion_contrast)
    params = list(model.parameters())
    grads = _grads(loss, params)
    norm = clip_by_global_norm(grads, tx.max_norm)
    _apply(state, tx, params, grads)
    return state, {"loss": loss.detach(), "epe": epe.detach(),
                   "grad_norm": norm}
