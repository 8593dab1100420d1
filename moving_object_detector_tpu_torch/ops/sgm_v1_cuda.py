"""Wrappers of the SGM v1 CUDA kernels (``csrc/sgm_v1.cu``).

Four kernels replace the JAX package's Pallas v1 kernels
(``ops/sgm_pallas.py``): the census transform, the Hamming cost volume,
the aggregation over the stored volume and the WTA. For a CUDA tensor a
wrapper launches its kernel on the current stream and adds one to its
entry of ``LAUNCHES`` per launch; for a CPU tensor it runs the plain
version in ``ops/sgm.py``, which computes the same values. A failed build
or launch raises.

The cost volume is (H, W, 128) int8 and the aggregated total (H, W, 128)
int16, D contiguous. v1 has no uniqueness test (``ops/sgm.py`` refuses
``uniqueness_ratio > 0`` with this backend).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import sgm, sgm_cuda

D = 128
LAUNCHES = {"sgm1_census": 0, "sgm1_cost": 0, "sgm1_aggregate": 0,
            "sgm1_wta": 0}
# The census kernel's tile, in pixels: a warp a row, 4 adjacent pixels a
# lane.
CENSUS_TILE_H = 8
CENSUS_TILE_W = 128
# The widest row whose two words a pixel the WTA keeps in a block's shared
# memory; wider rows keep them in global memory.
WTA_SMEM_WIDTH = sgm_cuda.SMEM_PER_BLOCK // 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_typed = False


def _lib():
    global _typed
    lib = _build.load("sgm_v1")
    if not _typed:
        lib.sgm1_census.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.sgm1_cost.argtypes = [_P, _P, _P, _I, _I, _P]
        lib.sgm1_aggregate.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.sgm1_wta.argtypes = [_P, _P, _P, _I, _I, _I, _I, _F, _P]
        for name in LAUNCHES:
            getattr(lib, name).restype = _I
        _typed = True
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launched(rc: int, name: str) -> None:
    _build.check(rc, name)
    LAUNCHES[name] += 1


def _check_volume(vol: torch.Tensor, dtype, what: str) -> torch.Tensor:
    if vol.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor")
    if vol.dtype != dtype or vol.dim() != 3 or vol.shape[-1] != D:
        raise ValueError(f"{what} must be (H, W, {D}) {dtype}, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    return vol.contiguous()


def _census(images, window) -> list:
    """One launch of the census kernel over one or two (H, W) images of
    one size on one CUDA device."""
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0 or wh * ww - 1 > 32:
        raise ValueError(f"census window {window}: both sides odd and at "
                         "most 32 neighbours (the signature is int32)")
    first = images[0]
    for img in images:
        if img.device != first.device or img.device.type != "cuda":
            raise ValueError("census images must be CUDA tensors on one "
                             "device")
        if img.dim() != 2 or img.shape != first.shape:
            raise ValueError(f"census inputs must be (H, W) of one size, "
                             f"got {[tuple(i.shape) for i in images]}")
    images = [img.float().contiguous() for img in images]
    outs = [torch.empty(img.shape, dtype=torch.int32, device=img.device)
            for img in images]
    h, w = images[0].shape
    last = len(images) - 1
    _launched(_lib().sgm1_census(
        images[0].data_ptr(), images[last].data_ptr(), outs[0].data_ptr(),
        outs[last].data_ptr(), len(images), h, w, wh // 2, ww // 2,
        _stream()), "sgm1_census")
    return outs


def census(img: torch.Tensor, window=(5, 5)) -> torch.Tensor:
    """Census transform, (H, W) -> (H, W) int32, bitwise equal to
    ``sgm.census_transform``: the kernel of ``census_pair`` on one
    image."""
    if img.device.type == "cpu":
        return sgm.census_transform(img, window)
    return _census([img], window)[0]


def census_pair(left: torch.Tensor, right: torch.Tensor, window=(5, 5)):
    """Census transforms of both views of a stereo pair, (cl, cr), in one
    launch; each bitwise equal to ``sgm.census_transform``. Both kernel
    generations ("pallas" and "pallas_v1" in ``sgm.sgm_disparity_raw``)
    take their census images from here."""
    if left.device != right.device:
        raise ValueError(f"census_pair: views on {left.device} and "
                         f"{right.device}")
    if left.device.type == "cpu":
        return (sgm.census_transform(left, window),
                sgm.census_transform(right, window))
    cl, cr = _census([left, right], window)
    return cl, cr


def cost_volume(cl: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """(H, W, 128) int8 Hamming cost popcount(cl(x) ^ cr(x - d)), 32 for
    x < d; equal to ``sgm.hamming_cost``."""
    if cl.device.type == "cpu":
        return sgm.hamming_cost(cl, cr, D).to(torch.int8)
    if cr.device != cl.device:
        raise ValueError("census images must lie on one device")
    if cl.dtype != torch.int32 or cr.dtype != torch.int32:
        raise TypeError("census images must be int32")
    if cl.dim() != 2 or cl.shape != cr.shape:
        raise ValueError(f"census shapes {tuple(cl.shape)} / "
                         f"{tuple(cr.shape)} must be equal (H, W)")
    cl, cr = cl.contiguous(), cr.contiguous()
    h, w = cl.shape
    cost = torch.empty((h, w, D), dtype=torch.int8, device=cl.device)
    _launched(_lib().sgm1_cost(cl.data_ptr(), cr.data_ptr(), cost.data_ptr(),
                               h, w, _stream()), "sgm1_cost")
    return cost


def _aggregate_pass(cost: torch.Tensor, total: torch.Tensor, p1: int,
                    p2: int, vertical: bool, accumulate: bool) -> None:
    """One launch of the aggregation kernel: both directions along the
    rows, or along the columns with ``vertical``; stores into ``total``
    or, with ``accumulate``, adds to what it holds."""
    h, w = cost.shape[:2]
    _launched(_lib().sgm1_aggregate(cost.data_ptr(), total.data_ptr(), h, w,
                                    p1, p2, int(vertical), int(accumulate),
                                    _stream()), "sgm1_aggregate")


def aggregate(cost: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """4-path aggregation of a stored (H, W, 128) int8 cost volume into the
    (H, W, 128) int16 total: one launch along the rows, one along the
    columns, each walking its lines both ways. Equal to
    ``sgm.aggregate_cost_volume``."""
    if cost.device.type == "cpu":
        return sgm.aggregate_cost_volume(cost, p1, p2)
    cost = _check_volume(cost, torch.int8, "the cost volume")
    p1, p2 = int(p1), int(p2)
    if not (p1 >= 0 and p2 >= 0 and 4 * (127 + p2) < 32768):
        raise ValueError(f"P1={p1}, P2={p2}: four path sums of up to "
                         "127 + P2 must fit int16")
    h, w = cost.shape[:2]
    total = torch.empty((h, w, D), dtype=torch.int16, device=cost.device)
    _aggregate_pass(cost, total, p1, p2, vertical=False, accumulate=False)
    _aggregate_pass(cost, total, p1, p2, vertical=True, accumulate=True)
    return total


def wta(total: torch.Tensor, subpixel: bool = True, lr_check: bool = True,
        lr_max_diff: float = 1.0) -> torch.Tensor:
    """(H, W) f32 disparity (-1 invalid) from the int16 total; bitwise
    equal to ``sgm.wta_from_total(total, uniqueness_ratio=0)``."""
    if total.device.type == "cpu":
        return sgm.wta_from_total(total, subpixel, lr_check, lr_max_diff)
    total = _check_volume(total, torch.int16, "the aggregated total")
    h, w = total.shape[:2]
    out = torch.empty((h, w), dtype=torch.float32, device=total.device)
    scratch = (torch.empty((h, w), dtype=torch.int32, device=total.device)
               if w > WTA_SMEM_WIDTH else None)
    _launched(_lib().sgm1_wta(
        total.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), h, w,
        int(bool(subpixel)), int(bool(lr_check)), float(lr_max_diff),
        _stream()), "sgm1_wta")
    return out
