"""Optical-flow layers (the JAX package's ``ops/flow_ops.py``) in NCHW:
exact bilinear backward warp, its gather-free two-pass approximation, the
plain correlation and its backward, bilinear resize."""

from __future__ import annotations

import torch

from .resize import resize_bilinear_hw


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the same values as ``clamp``, and JAX's gradient at a
    bound. ``jnp.clip`` is a max then a min, whose gradients split a tie
    in half; ``clamp`` passes the whole gradient at a bound.
    ``torch.maximum`` / ``torch.minimum`` split ties as JAX does; without
    a gradient to take, one ``clamp`` launch does."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.clamp(lo, hi)
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


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
    su_c = _clip(su, 0.0, w - 1.0)
    sv_c = _clip(sv, 0.0, h - 1.0)
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


def warp_two_pass(features: torch.Tensor, flow: torch.Tensor,
                  max_dy: int = 32, max_dx: int = 32) -> torch.Tensor:
    """Gather-free approximation of ``warp`` (FlowNetConfig.warp_backend
    "two_pass"): a vertical pass, then a horizontal one, each a sum of
    2R+1 shifted slices weighted by one-hot selects. Pass 2 samples the
    vertically warped intermediate at x + u(y, x), so its vertical
    coordinate came from v(y, x + u): exact for flows constant along
    rows, off by O(|u| |dv/dx|) elsewhere. Flow components beyond
    +-(max - 1) are clipped; samples outside the image are zero."""
    b, c, h, w = features.shape
    rv = min(max_dy, h)
    rh = min(max_dx, w)
    dt = flow.dtype
    u = torch.arange(w, dtype=dt, device=flow.device)[None, None, :]
    v = torch.arange(h, dtype=dt, device=flow.device)[None, :, None]
    su = u + _clip(flow[:, 0], -(rh - 1), rh - 1)
    sv = v + _clip(flow[:, 1], -(rv - 1), rv - 1)
    inside = (su >= 0) & (su <= w - 1) & (sv >= 0) & (sv <= h - 1)

    v0 = torch.floor(sv)
    bw = (sv - v0)[:, None]
    dyk = (v0 - v).to(torch.int32)[:, None]
    fp = torch.nn.functional.pad(features, (0, 0, rv, rv))
    g = torch.zeros_like(features)
    for dy in range(-rv, rv + 1):
        wgt = (torch.where(dyk == dy, 1.0 - bw, 0.0)
               + torch.where(dyk == dy - 1, bw, 0.0))
        g = g + wgt * fp[:, :, rv + dy: rv + dy + h]

    u0 = torch.floor(su)
    aw = (su - u0)[:, None]
    dxk = (u0 - u).to(torch.int32)[:, None]
    gp = torch.nn.functional.pad(g, (rh, rh))
    out = torch.zeros_like(features)
    for dx in range(-rh, rh + 1):
        wgt = (torch.where(dxk == dx, 1.0 - aw, 0.0)
               + torch.where(dxk == dx - 1, aw, 0.0))
        out = out + wgt * gp[:, :, :, rh + dx: rh + dx + w]
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


def correlation_backward(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                         search_range: int = 4):
    """Plain gradients of ``correlation`` given the output's gradient ``g``
    (B, (2r+1)^2, H, W): (g1, g2), each (B, C, H, W), with

        g1[b, c, y, x] = (1/C) sum_k g[b, k, y, x] f2[b, c, y + dy, x + dx]
        g2[b, c, y, x] = (1/C) sum_k g[b, k, y - dy, x - dx]
                                     f1[b, c, y - dy, x - dx]

    terms whose pixel falls outside the image being zero. Both are gathers
    (each output reads its neighbours; nothing is scattered). The plain
    version of the CUDA kernel ``corr_backward``."""
    b, c, h, w = f1.shape
    r = search_range
    pad = (r, r, r, r)
    f1p = torch.nn.functional.pad(f1, pad)
    f2p = torch.nn.functional.pad(f2, pad)
    gp = torch.nn.functional.pad(g, pad)
    g1 = torch.zeros_like(f1)
    g2 = torch.zeros_like(f2)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            g1 = g1 + g[:, k:k + 1] * f2p[:, :, r + dy: r + dy + h,
                                          r + dx: r + dx + w]
            g2 = g2 + (gp[:, k:k + 1, r - dy: r - dy + h, r - dx: r - dx + w]
                       * f1p[:, :, r - dy: r - dy + h, r - dx: r - dx + w])
            k += 1
    return g1 / c, g2 / c


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """JAX-image.resize-equivalent bilinear resize of (B, C, H, W) to
    (B, C, size[0], size[1])."""
    return resize_bilinear_hw(x, size, h_dim=2)
