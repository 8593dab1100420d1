"""Wrapper of the connected-components CUDA kernels (``csrc/cc.cu``).

Replaces the JAX package's Pallas kernel ``connected_components_pallas``
(``ops/clustering_pallas.py``): depth-gated components of the dynamic
pixels over the sign-consistent window offsets, each pixel labelled with
the smallest flat index of its component, background H*W. For CUDA
tensors the wrapper launches the kernels (a union-find in global memory,
no host loop and no fetch from the device) and adds one to
``LAUNCHES["cc"]``; for CPU tensors it runs the plain fixpoint
``clustering.connected_components``. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import clustering

LAUNCHES = {"cc": 0}
_typed = False


def _lib():
    global _typed
    lib = _build.load("cc")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cc_labels.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.cc_labels.restype = I
        _typed = True
    return lib


def connected_components(dynamic, depth, depth_diff, neighbor_distance=4,
                         max_iters: int = 64, stencil_radius=None):
    """(H, W) int32 labels of the dynamic-pixel graph, as
    ``clustering.connected_components`` defines them.

    ``depth_diff`` and ``neighbor_distance`` may be 0-d tensors: the
    kernel reads both from device memory, so a retune needs no rebuild
    and no fetch. ``neighbor_distance`` is clamped to [0,
    ``stencil_radius``]. ``dynamic`` and ``depth`` may be strided views
    and are read in place.

    The union-find always converges, so ``max_iters`` bounds only the
    plain version's fixpoint (which returns an unconverged labelling when
    it runs out) and is ignored on the card. The reference kernel's cap on
    its scan reach (``ClustererConfig.cc_scan_span``) has no meaning for
    this design and is not taken. The plain version alone offers
    ``return_iters``."""
    if dynamic.device.type == "cpu":
        return clustering.connected_components(
            dynamic, depth, depth_diff, neighbor_distance=neighbor_distance,
            max_iters=max_iters, stencil_radius=stencil_radius)
    if stencil_radius is None:
        if not isinstance(neighbor_distance, int):
            raise TypeError(
                "a tensor neighbor_distance requires a stencil_radius")
        stencil_radius = neighbor_distance
    dev = dynamic.device
    if dev.type != "cuda" or depth.device != dev:
        raise ValueError("CC inputs must be CUDA tensors on one device")
    if dynamic.dtype != torch.bool:
        raise TypeError("the dynamic map must be bool")
    if depth.dtype != torch.float32:
        raise TypeError("depth must be f32")
    if dynamic.dim() != 2 or depth.shape != dynamic.shape:
        raise ValueError(f"shapes {tuple(dynamic.shape)} / "
                         f"{tuple(depth.shape)} must be equal (H, W)")
    if stencil_radius < 0:
        raise ValueError("stencil_radius must not be negative")
    dd = torch.as_tensor(depth_diff, dtype=torch.float32, device=dev)
    nd = torch.as_tensor(neighbor_distance, dtype=torch.int32, device=dev)
    if dd.numel() != 1 or nd.numel() != 1:
        raise ValueError("depth_diff and neighbor_distance must be scalars")
    h, w = dynamic.shape
    labels = torch.empty((h, w), dtype=torch.int32, device=dev)
    rc = _lib().cc_labels(
        dynamic.data_ptr(), depth.data_ptr(), dd.data_ptr(), nd.data_ptr(),
        labels.data_ptr(), h, w, dynamic.stride(0), dynamic.stride(1),
        depth.stride(0), depth.stride(1), int(stencil_radius),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "cc_labels")
    LAUNCHES["cc"] += 1
    return labels
