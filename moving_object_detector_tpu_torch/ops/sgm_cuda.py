"""Wrappers of the SGM v2 CUDA kernels (``csrc/sgm_v2.cu``).

Three kernels replace the JAX package's Pallas v2 kernels
(``ops/sgm_pallas2.py``): the vertical DP, the horizontal DP and the WTA.
For a CUDA tensor a wrapper launches its kernel on the current stream and
adds one to its entry of ``LAUNCHES``; for a CPU tensor it runs the plain
version in ``ops/sgm.py``, which computes the same (H, W, 128) int8
deltas and the same disparity. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import sgm

D = 128
LAUNCHES = {"sgm_vertical": 0, "sgm_horizontal": 0, "sgm_wta": 0}
# The WTA kernel keeps one image row in shared memory, 4.5 words a pixel.
MAX_WTA_WIDTH = 8192

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_typed = False


def _lib():
    global _typed
    lib = _build.load("sgm_v2")
    if not _typed:
        for name in ("sgm_vertical", "sgm_horizontal"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
            fn.restype = _I
        lib.sgm_wta.argtypes = [_P] * 7 + [_I, _I, _I, _I, _F, _F, _P]
        lib.sgm_wta.restype = _I
        _typed = True
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_census(cl: torch.Tensor, cr: torch.Tensor):
    if cl.device.type != "cuda" or cr.device != cl.device:
        raise ValueError("census images must be CUDA tensors on one device")
    if cl.dtype != torch.int32 or cr.dtype != torch.int32:
        raise TypeError("census images must be int32")
    if cl.dim() != 2 or cl.shape != cr.shape:
        raise ValueError(f"census shapes {tuple(cl.shape)} / "
                         f"{tuple(cr.shape)} must be equal (H, W)")
    return cl.contiguous(), cr.contiguous()


def _dp(name: str, cl, cr, p1: int, p2: int):
    sgm._check_p2(p2)
    cl, cr = _check_census(cl, cr)
    h, w = cl.shape
    out_f = torch.empty((h, w, D), dtype=torch.int8, device=cl.device)
    out_b = torch.empty_like(out_f)
    rc = getattr(_lib(), name)(cl.data_ptr(), cr.data_ptr(),
                               out_f.data_ptr(), out_b.data_ptr(),
                               h, w, int(p1), int(p2), _stream())
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out_f, out_b


def vertical_deltas(cl: torch.Tensor, cr: torch.Tensor, p1: int, p2: int):
    """Top-down and bottom-up path deltas, each (H, W, 128) int8."""
    if cl.device.type == "cpu":
        return sgm.vertical_deltas(cl, cr, p1, p2, D)
    return _dp("sgm_vertical", cl, cr, p1, p2)


def horizontal_deltas(cl: torch.Tensor, cr: torch.Tensor, p1: int, p2: int):
    """Left-right and right-left path deltas, each (H, W, 128) int8."""
    if cl.device.type == "cpu":
        return sgm.horizontal_deltas(cl, cr, p1, p2, D)
    return _dp("sgm_horizontal", cl, cr, p1, p2)


def wta(hf, hb, vf, vb, cl, cr, subpixel: bool = True, lr_check: bool = True,
        lr_max_diff: float = 1.0, uniqueness_ratio: float = 0.0):
    """(H, W) f32 disparity (-1 invalid) from the four delta volumes and
    the census images."""
    if cl.device.type == "cpu":
        total = sgm.total_from_deltas(hf, hb, vf, vb, cl, cr)
        return sgm.wta_from_total(total, subpixel, lr_check, lr_max_diff,
                                  uniqueness_ratio)
    cl, cr = _check_census(cl, cr)
    h, w = cl.shape
    if w > MAX_WTA_WIDTH:
        raise ValueError(f"width {w} exceeds the WTA kernel's "
                         f"{MAX_WTA_WIDTH} (one row in shared memory)")
    vols = []
    for v in (hf, hb, vf, vb):
        if v.device != cl.device or v.dtype != torch.int8 or \
                tuple(v.shape) != (h, w, D):
            raise ValueError(f"delta volumes must be ({h}, {w}, {D}) int8 "
                             f"on {cl.device}")
        v = v.contiguous()
        if v.data_ptr() % 16:
            raise ValueError("delta volumes must be 16-byte aligned (the "
                             "kernel loads 16 bytes a lane)")
        vols.append(v)
    out = torch.empty((h, w), dtype=torch.float32, device=cl.device)
    rc = _lib().sgm_wta(
        *(v.data_ptr() for v in vols), cl.data_ptr(), cr.data_ptr(),
        out.data_ptr(), h, w, int(bool(subpixel)), int(bool(lr_check)),
        float(lr_max_diff), float(uniqueness_ratio), _stream())
    _build.check(rc, "sgm_wta")
    LAUNCHES["sgm_wta"] += 1
    return out
