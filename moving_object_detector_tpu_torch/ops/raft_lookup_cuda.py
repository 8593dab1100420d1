"""Wrapper of RAFT's correlation-lookup CUDA kernel
(``csrc/raft_lookup.cu``) and its plain version.

The lookup samples every level of RAFT's all-pairs correlation pyramid
around each pixel's current match (the published ``CorrBlock.__call__``:
one ``grid_sample`` a level with ``align_corners``, zeros outside the map,
then a concatenation). It replaces no kernel of the JAX package, which
has no RAFT. On CUDA tensors ``raft_lookup`` launches the kernel, one
launch for all levels, and adds one to ``LAUNCHES["raft_lookup"]``; on CPU
tensors it runs ``raft_lookup_plain``. A failed build or launch raises.
Inside a CUDA graph's capture ``raft_lookup`` is a cut point
(``utils/cuda_graphs.py``): each replay launches it between the graphs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import cuda_graphs

LAUNCHES = {"raft_lookup": 0}
MAX_LEVELS = 4  # csrc/raft_lookup.cu kMaxLevels
MAX_RADIUS = 4  # kMaxRadius
_typed = False


def _lib():
    global _typed
    lib = _build.load("raft_lookup")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.raft_lookup.argtypes = [P, P, P, I, P, P, I, I, I, I, P]
        lib.raft_lookup.restype = I
        _typed = True
    return lib


def _source_index(c: torch.Tensor, size: int) -> torch.Tensor:
    """grid_sample's unnormalised coordinate (``align_corners``) of pixel
    coordinate ``c`` after the published ``bilinear_sampler`` normalised
    it to [-1, 1]."""
    s = float(size - 1)
    return ((2.0 * c / s - 1.0 + 1.0) / 2.0) * s


def raft_lookup_plain(pyramid, coords: torch.Tensor,
                      radius: int = 4) -> torch.Tensor:
    """The lookup in plain PyTorch, the kernel's arithmetic: ``pyramid``
    a list of (B h w, H_l, W_l) f32 maps, ``coords`` (B, 2, h, w) f32 (x,
    y) on level 0's pixel grid -> (B, L (2r+1)^2, h, w) f32, channel
    ``l (2r+1)^2 + (dx + r)(2r+1) + (dy + r)`` the bilinear sample of
    level l at (x / 2^l + dx, y / 2^l + dy), a tap outside the map
    adding nothing."""
    b, _, h, w = coords.shape
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                     device=coords.device)
    c = coords.permute(0, 2, 3, 1).reshape(b * h * w, 2)
    outs = []
    for lvl, cmap in enumerate(pyramid):
        n, hl, wl = cmap.shape
        cl = c / float(2 ** lvl)
        xi = _source_index(cl[:, 0, None] + d, wl)  # (n, k): dx
        yi = _source_index(cl[:, 1, None] + d, hl)  # (n, k): dy
        x0, y0 = torch.floor(xi), torch.floor(yi)
        fx = ((x0 + 1.0) - xi, xi - x0)
        fy = ((y0 + 1.0) - yi, yi - y0)
        flat = cmap.reshape(n, hl * wl)

        def tap(xx, yy, weight):
            """(n, k dx, k dy) values at columns xx and rows yy times
            their weights, 0 outside the map (and at a coordinate that is
            not a number)."""
            ok = (((xx >= 0) & (xx <= wl - 1))[:, :, None]
                  & ((yy >= 0) & (yy <= hl - 1))[:, None, :])
            idx = (yy.nan_to_num(0.0).clamp(0, hl - 1).long()[:, None, :]
                   * wl
                   + xx.nan_to_num(0.0).clamp(0, wl - 1).long()[:, :, None])
            v = torch.gather(flat, 1, idx.reshape(n, k * k)).reshape(n, k, k)
            return torch.where(ok, v * weight, torch.zeros_like(v))

        acc = torch.zeros((n, k, k), dtype=cmap.dtype, device=cmap.device)
        for (ddx, ddy) in ((0, 0), (1, 0), (0, 1), (1, 1)):  # nw ne sw se
            acc = acc + tap(x0 + ddx, y0 + ddy,
                            fx[ddx][:, :, None] * fy[ddy][:, None, :])
        outs.append(acc.reshape(b, h, w, k * k))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous()


def _kernel_inputs(pyramid, coords, radius):
    """The kernel's refusals, for tensors not on the CPU; the inputs made
    contiguous."""
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"{len(pyramid)} levels: the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius}: the kernel takes 1 to "
                         f"{MAX_RADIUS}")
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords {tuple(coords.shape)} must be (B, 2, h, w)")
    b, _, h, w = coords.shape
    tensors = [coords, *pyramid]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the lookup kernel takes f32 maps and coordinates")
    if any(t.device.type != "cuda" or t.device != coords.device
           for t in tensors):
        raise ValueError("lookup inputs must be CUDA tensors on one device")
    for cmap in pyramid:
        if cmap.dim() != 3 or cmap.shape[0] != b * h * w or min(
                cmap.shape) < 1:
            raise ValueError(f"level {tuple(cmap.shape)} must be (B h w = "
                             f"{b * h * w}, H_l, W_l), non-empty")
    return [t.contiguous() for t in pyramid], coords.contiguous()


def raft_lookup(pyramid, coords: torch.Tensor, radius: int = 4,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L (2r+1)^2, h, w) f32 samples of every pyramid level around
    ``coords`` (``raft_lookup_plain`` states them), written into ``out``
    where given. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if coords.device.type == "cpu":
        feats = raft_lookup_plain(pyramid, coords, radius)
        return feats if out is None else out.copy_(feats)
    pyramid, coords = _kernel_inputs(pyramid, coords, radius)
    b, _, h, w = coords.shape
    levels = len(pyramid)
    shape = (b, levels * (2 * radius + 1) ** 2, h, w)
    cut = cuda_graphs.cut_point(__name__, "raft_lookup",
                                (pyramid, coords, radius), shape,
                                torch.float32, coords.device)
    if cut is not None:
        return cut
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=coords.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.device != coords.device or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}: the kernel writes a contiguous "
                         f"{shape} f32 on {coords.device}")
    maps = (ctypes.c_void_p * levels)(*[t.data_ptr() for t in pyramid])
    heights = (ctypes.c_int * levels)(*[t.shape[1] for t in pyramid])
    widths = (ctypes.c_int * levels)(*[t.shape[2] for t in pyramid])
    rc = _lib().raft_lookup(
        ctypes.cast(maps, ctypes.c_void_p),
        ctypes.cast(heights, ctypes.c_void_p),
        ctypes.cast(widths, ctypes.c_void_p), levels, coords.data_ptr(),
        out.data_ptr(), b, h, w, radius,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "raft_lookup")
    LAUNCHES["raft_lookup"] += 1
    return out
