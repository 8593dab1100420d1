"""Bilinear resize with the semantics of JAX's ``image.resize(...,
"bilinear")``.

That function antialiases when it shrinks: the triangle kernel is widened
by the shrink factor, so a 2x reduction averages four source pixels with
weights (1, 3, 3, 1)/8 instead of sampling two. ``F.interpolate`` without
``antialias`` is a different function. This module builds the same
separable weight matrices as JAX's ``image.scale_and_translate`` (sample
positions, widened kernel, edge renormalization, zeroing outside the
input) in f32 and applies them as two small matrix products. Enlarging
uses the same code with an unwidened kernel.
"""

from __future__ import annotations

import contextlib
import functools

import torch

# While ``holding`` runs: every weight matrix a resize read. A CUDA graph
# captured meanwhile reads them by address, so it keeps them alive past
# their eviction from ``weight_matrix``'s cache.
_held: list | None = None


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 resampling weights along one axis, built
    once per (sizes, device) and cached; callers must not modify it."""
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :]
         - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    x = x / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


@contextlib.contextmanager
def holding():
    """Collect into the list it yields every weight matrix the resizes
    inside the block read."""
    global _held
    prev, _held = _held, []
    try:
        yield _held
    finally:
        _held = prev


def resize_bilinear_hw(x: torch.Tensor, size, h_dim: int = 0) -> torch.Tensor:
    """Resize the two spatial axes ``h_dim`` and ``h_dim + 1`` of ``x`` to
    ``size`` = (H', W'). Axes whose size does not change are skipped, as
    JAX's image.resize skips them. Computes in ``x.dtype`` like the JAX
    function (bf16 inputs get bf16 weights)."""
    out = x
    for axis, n in ((h_dim, size[0]), (h_dim + 1, size[1])):
        m = out.shape[axis]
        if m == n:
            continue
        wmat = weight_matrix(m, n, x.device)
        if _held is not None:
            _held.append(wmat)
        wmat = wmat.to(x.dtype)
        out = torch.movedim(
            torch.tensordot(torch.movedim(out, axis, -1), wmat, dims=1),
            -1, axis,
        )
    return out


def resize_image(img: torch.Tensor, size) -> torch.Tensor:
    """(H, W[, C]) image -> (H', W'[, C])."""
    return resize_bilinear_hw(img, size, h_dim=0)
