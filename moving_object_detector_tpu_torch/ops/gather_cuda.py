"""Wrapper of the windowed-gather CUDA kernel (``csrc/gather.cu``).

Replaces the JAX package's Pallas kernel ``window_gather_pallas``
(``ops/gather_pallas.py``): the previous disparity at the flow-matched
pixel, NaN for a match outside the image or outside the covered window
(``geometry.window_gather`` states the window). For CUDA tensors the
wrapper launches the kernel and adds one to ``LAUNCHES["gather"]``; for
CPU tensors it runs the plain version ``geometry.window_gather``. A
failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import geometry

LAUNCHES = {"gather": 0}
_typed = False


def _lib():
    global _typed
    lib = _build.load("gather")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.window_gather.argtypes = [P, P, P, P, I, I, I, I, P]
        lib.window_gather.restype = I
        _typed = True
    return lib


def window_gather(src: torch.Tensor, v_idx: torch.Tensor,
                  u_idx: torch.Tensor, v_radius: int = 16,
                  h_radius: int = 128) -> torch.Tensor:
    """(H, W) f32 ``src`` gathered at the (H, W) int32 row and column
    indices: (H, W) f32, NaN outside the image or the covered window."""
    if src.device.type == "cpu":
        return geometry.window_gather(src, v_idx, u_idx, v_radius, h_radius)
    if (src.device.type != "cuda" or v_idx.device != src.device
            or u_idx.device != src.device):
        raise ValueError("gather inputs must be CUDA tensors on one device")
    if src.dtype != torch.float32:
        raise TypeError("the gather kernel takes an f32 source")
    if v_idx.dtype != torch.int32 or u_idx.dtype != torch.int32:
        raise TypeError("the gather kernel takes int32 indices")
    if src.dim() != 2 or v_idx.shape != src.shape or u_idx.shape != src.shape:
        raise ValueError(f"shapes {tuple(src.shape)} / {tuple(v_idx.shape)} "
                         f"/ {tuple(u_idx.shape)} must be equal (H, W)")
    if v_radius < 0 or h_radius < 0:
        raise ValueError("the window radii must not be negative")
    src, v_idx, u_idx = src.contiguous(), v_idx.contiguous(), \
        u_idx.contiguous()
    h, w = src.shape
    rg, rt = geometry.window_spans(v_radius, h_radius)
    out = torch.empty_like(src)
    rc = _lib().window_gather(src.data_ptr(), v_idx.data_ptr(),
                              u_idx.data_ptr(), out.data_ptr(), h, w, rg, rt,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "window_gather")
    LAUNCHES["gather"] += 1
    return out
