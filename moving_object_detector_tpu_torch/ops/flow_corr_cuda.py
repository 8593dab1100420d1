"""Wrapper of the PWC-Net correlation CUDA kernel (``csrc/corr.cu``).

Replaces the JAX package's Pallas kernel ``correlation_pallas``
(``ops/flow_corr_pallas.py``), forward only: training needs the backward
and comes in a later slice. For a CUDA tensor the wrapper launches the
kernel and adds one to ``LAUNCHES["corr"]``; for a CPU tensor it runs the
plain version ``flow_ops.correlation``. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import flow_ops

LAUNCHES = {"corr": 0}
_typed = False


def _lib():
    global _typed
    lib = _build.load("corr")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.corr_forward.argtypes = [P, P, P, I, I, I, I, I, P]
        lib.corr_forward.restype = I
        _typed = True
    return lib


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                search_range: int = 4) -> torch.Tensor:
    """(B, C, H, W) f32 pair -> (B, (2r+1)^2, H, W) f32 mean-channel local
    cost volume, dy-major offsets, zero outside the image."""
    if f1.device.type == "cpu":
        return flow_ops.correlation(f1, f2, search_range)
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError("correlation inputs must be CUDA tensors on one "
                         "device")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError("the correlation kernel takes f32 inputs")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"shapes {tuple(f1.shape)} / {tuple(f2.shape)} "
                         "must be equal (B, C, H, W)")
    if not 1 <= search_range <= 4:
        raise ValueError(f"search_range {search_range}: the kernel is "
                         "built for 1..4")
    f1 = f1.contiguous()
    f2 = f2.contiguous()
    b, c, h, w = f1.shape
    k = (2 * search_range + 1) ** 2
    out = torch.empty((b, k, h, w), dtype=torch.float32, device=f1.device)
    rc = _lib().corr_forward(f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                             b, c, h, w, search_range,
                             torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "corr_forward")
    LAUNCHES["corr"] += 1
    return out
