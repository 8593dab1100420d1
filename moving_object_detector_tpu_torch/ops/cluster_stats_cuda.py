"""Wrapper of the cluster-stats CUDA kernel (``csrc/cluster_stats.cu``).

Replaces the JAX package's Pallas kernel ``cluster_stats_pallas``
(``ops/cluster_stats_pallas.py``): compact ids, AABB corners and member
counts of up to 32 selected roots in one launch. For CUDA tensors the
wrapper launches the kernel and adds one to ``LAUNCHES["cluster_stats"]``;
for CPU tensors it runs the plain version ``cluster_stats.cluster_stats``.
A failed build or launch raises.

The kernel's blocks meet in a small accumulator in global memory, which
its last block leaves zeroed for the next call. The wrapper keeps one such
accumulator per (device, stream): calls on one stream run in order, and
calls on two streams never share one.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import cluster_stats as plain

MAX_CAP = 32
STATS_THREADS = 256  # threads a block; a warp takes 32 pixels of a row
ACC_WORDS = 8 * MAX_CAP + 1  # the kernel's kAcc values a slot and a ticket
LAUNCHES = {"cluster_stats": 0}
_typed = False
_accumulators: dict[tuple[int, int], torch.Tensor] = {}


def _lib():
    global _typed
    lib = _build.load("cluster_stats")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cluster_stats.argtypes = [P, P, P, P, P, P, P, P,
                                      I, I, I, I, P]
        lib.cluster_stats.restype = I
        _typed = True
    return lib


def _accumulator(dev: torch.device, stream: int) -> torch.Tensor:
    """The zeroed accumulator of this device and stream, made on first
    use."""
    key = (dev.index, stream)
    acc = _accumulators.get(key)
    if acc is None:
        acc = torch.zeros((ACC_WORDS,), dtype=torch.int32, device=dev)
        _accumulators[key] = acc
    return acc


def cluster_stats(labels: torch.Tensor, points: torch.Tensor,
                  roots: torch.Tensor):
    """(cid, mins, maxs, csize) as ``cluster_stats.cluster_stats`` gives
    them, all four views of one allocation. ``points`` may be a strided
    view (a crop of the frame's cloud) as long as a pixel's three floats
    are adjacent; it is read in place. A NaN coordinate of a member pixel
    makes that slot's min and max on that axis NaN, as in the plain
    version. A min or max of zero may carry either sign."""
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
    if points.stride(2) != 1 or points.stride(1) != 3:
        points = points.contiguous()
    labels, roots = labels.contiguous(), roots.contiguous()
    h, w = labels.shape
    n = h * w
    out = torch.empty((n + 7 * cap,), dtype=torch.int32, device=dev)
    cid = out[:n].view(h, w)
    mins = out[n:n + 3 * cap].view(torch.float32).view(cap, 3)
    maxs = out[n + 3 * cap:n + 6 * cap].view(torch.float32).view(cap, 3)
    csize = out[n + 6 * cap:]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().cluster_stats(
        labels.data_ptr(), points.data_ptr(), roots.data_ptr(),
        cid.data_ptr(), mins.data_ptr(), maxs.data_ptr(), csize.data_ptr(),
        _accumulator(dev, stream).data_ptr(), h, w, points.stride(0), cap,
        stream)
    _build.check(rc, "cluster_stats")
    LAUNCHES["cluster_stats"] += 1
    return cid, mins, maxs, csize
