"""Wrapper of the cluster-stats CUDA kernel (``csrc/cluster_stats.cu``).

Replaces the JAX package's Pallas kernel ``cluster_stats_pallas``
(``ops/cluster_stats_pallas.py``): compact ids, AABB corners and member
counts of up to 32 selected roots in one pass over the pixels. For CUDA
tensors the wrapper launches the kernel and adds one to
``LAUNCHES["cluster_stats"]``; for CPU tensors it runs the plain version
``cluster_stats.cluster_stats``. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import cluster_stats as plain

MAX_CAP = 32
LAUNCHES = {"cluster_stats": 0}
_typed = False


def _lib():
    global _typed
    lib = _build.load("cluster_stats")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cluster_stats.argtypes = [P, P, P, P, P, P, P, P,
                                      I, I, I, I, I, P]
        lib.cluster_stats.restype = I
        _typed = True
    return lib


def cluster_stats(labels: torch.Tensor, points: torch.Tensor,
                  roots: torch.Tensor):
    """(cid, mins, maxs, csize) as ``cluster_stats.cluster_stats`` gives
    them. ``points`` may be a strided view (a crop of the frame's cloud)
    as long as its last dimension is dense; it is read in place. A NaN
    coordinate of a member pixel makes that slot's min and max on that
    axis NaN, as in the plain version. A min or max of zero may carry
    either sign."""
    if labels.device.type == "cpu":
        return plain.cluster_stats(labels, points, roots)
    dev = labels.device
    if dev.type != "cuda" or points.device != dev or roots.device != dev:
        raise ValueError("cluster-stats inputs must be CUDA tensors on one "
                         "device")
    if labels.dtype != torch.int32 or roots.dtype != torch.int32:
        raise TypeError("labels and roots must be int32")
    if points.dtype != torch.float32:
        raise TypeError("points must be f32")
    if labels.dim() != 2 or tuple(points.shape) != (*labels.shape, 3):
        raise ValueError(f"labels {tuple(labels.shape)} / points "
                         f"{tuple(points.shape)} must be (h, w) / (h, w, 3)")
    cap = roots.shape[0]
    if roots.dim() != 1 or not 1 <= cap <= MAX_CAP:
        raise ValueError(f"roots must be (cap,) with 1 <= cap <= {MAX_CAP}")
    if points.stride(2) != 1:
        points = points.contiguous()
    labels, roots = labels.contiguous(), roots.contiguous()
    h, w = labels.shape
    cid = torch.empty((h, w), dtype=torch.int32, device=dev)
    mins = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    maxs = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    csize = torch.empty((cap,), dtype=torch.int32, device=dev)
    scratch = torch.empty((8 * cap,), dtype=torch.int32, device=dev)
    rc = _lib().cluster_stats(
        labels.data_ptr(), points.data_ptr(), roots.data_ptr(),
        cid.data_ptr(), mins.data_ptr(), maxs.data_ptr(), csize.data_ptr(),
        scratch.data_ptr(), h, w, points.stride(0), points.stride(1), cap,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "cluster_stats")
    LAUNCHES["cluster_stats"] += 1
    return cid, mins, maxs, csize
