"""Optical-flow layers (the JAX package's ``ops/flow_ops.py``) in NCHW:
exact bilinear backward warp, the plain correlation, bilinear resize."""

from __future__ import annotations

import torch

from .resize import resize_bilinear_hw


def warp(features: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``features`` (B, C, H, W) by ``flow`` (B, 2, H, W):
    out(x) = features(x + flow(x)), bilinear, zero outside the image.
    Computes in ``flow.dtype`` like the JAX function."""
    b, c, h, w = features.shape
    dt = flow.dtype
    u = torch.arange(w, dtype=dt, device=flow.device)[None, None, :]
    v = torch.arange(h, dtype=dt, device=flow.device)[None, :, None]
    su = u + flow[:, 0]
    sv = v + flow[:, 1]
    inside = (su >= 0) & (su <= w - 1) & (sv >= 0) & (sv <= h - 1)
    su_c = su.clamp(0.0, w - 1.0)
    sv_c = sv.clamp(0.0, h - 1.0)
    u0 = torch.floor(su_c)
    v0 = torch.floor(sv_c)
    du = (su_c - u0)[:, None]
    dv = (sv_c - v0)[:, None]
    u0i = u0.long()
    v0i = v0.long()
    u1i = (u0i + 1).clamp(max=w - 1)
    v1i = (v0i + 1).clamp(max=h - 1)
    flat = features.reshape(b, c, h * w)

    def tap(vi, ui):
        idx = (vi * w + ui).reshape(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).reshape(b, c, h, w)

    out = (tap(v0i, u0i) * (1 - du) * (1 - dv) + tap(v0i, u1i) * du * (1 - dv)
           + tap(v1i, u0i) * (1 - du) * dv + tap(v1i, u1i) * du * dv)
    return torch.where(inside[:, None], out, torch.zeros_like(out))


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                search_range: int = 4) -> torch.Tensor:
    """Plain local cost volume: (B, C, H, W) pair -> (B, (2r+1)^2, H, W),
    the mean over channels of f1(x) * f2(x + offset), dy-major offsets,
    zero outside the image. The plain version of the CUDA kernel in
    ``flow_corr_cuda.py``."""
    b, c, h, w = f1.shape
    r = search_range
    f2p = torch.nn.functional.pad(f2, (r, r, r, r))
    outputs = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = f2p[:, :, r + dy: r + dy + h, r + dx: r + dx + w]
            outputs.append((f1 * shifted).mean(dim=1))
    return torch.stack(outputs, dim=1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """JAX-image.resize-equivalent bilinear resize of (B, C, H, W) to
    (B, C, size[0], size[1])."""
    return resize_bilinear_hw(x, size, h_dim=2)
