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
SMEM_PER_BLOCK = 232448  # bytes a block may have on an H100 (opt-in)
# The vertical DP: image rows a staged block holds, and the most columns
# a block owns (a warp each).
V_ROWS = 32
V_MAX_STRIP = 32


def v_strip(w: int, sms: int) -> int:
    """Columns a block of the vertical DP owns for a row of ``w`` pixels
    on a card of ``sms`` SMs: the fewest that still let its 2 ceil(w /
    strip) blocks fit the SMs once, so that every SM scans about as many
    columns, at most V_MAX_STRIP."""
    return max(1, min(V_MAX_STRIP, -(-2 * w // sms)))




def h_dp_smem_bytes(w: int) -> int:
    """Shared memory of the horizontal DP kernel for a row of ``w`` pixels:
    the left census line and the right one with a pad word every 32."""
    return 4 * (w + (w - 1) + (w - 1) // 32 + 1)


def wta_smem_bytes(w: int) -> int:
    """Shared memory of the WTA kernel for a row of ``w`` pixels: the right
    census line and the right view's minimum with 4 pad words every 16,
    the left census line and the disparity."""
    padded = (w - 1) + ((w - 1) // 16) * 4 + 1
    return 4 * (2 * padded + 2 * w)


def _widest(smem_bytes) -> int:
    w = 1
    while smem_bytes(w + 1) <= SMEM_PER_BLOCK:
        w += 1
    return w


# The widest rows whose lines a block stages in shared memory. Wider rows
# take each kernel's second instantiation, which reads them from global
# memory: no width is refused.
DP_SMEM_WIDTH = _widest(h_dp_smem_bytes)
WTA_SMEM_WIDTH = _widest(wta_smem_bytes)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_typed = False


def _lib():
    global _typed
    lib = _build.load("sgm_v2")
    if not _typed:
        lib.sgm_vertical.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.sgm_horizontal.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.sgm_wta.argtypes = [_P] * 8 + [_I, _I, _I, _I, _F, _F, _P]
        for name in LAUNCHES:
            getattr(lib, name).restype = _I
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


def _dp(name: str, cl, cr, p1: int, p2: int, strip: int = 0):
    """Launches one DP kernel; ``strip`` > 0 overrides the vertical DP's
    strip (``v_strip``), for timing it at other strips."""
    sgm._check_penalties(p1, p2)
    cl, cr = _check_census(cl, cr)
    h, w = cl.shape
    out_f = torch.empty((h, w, D), dtype=torch.int8, device=cl.device)
    out_b = torch.empty_like(out_f)
    args = [cl.data_ptr(), cr.data_ptr(), out_f.data_ptr(), out_b.data_ptr(),
            h, w, int(p1), int(p2)]
    if name == "sgm_vertical":
        sms = torch.cuda.get_device_properties(cl.device).multi_processor_count
        args.append(strip or v_strip(w, sms))
    rc = getattr(_lib(), name)(*args, _stream())
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
    scratch = (torch.empty((h, w), dtype=torch.int32, device=cl.device)
               if w > WTA_SMEM_WIDTH else None)
    rc = _lib().sgm_wta(
        *(v.data_ptr() for v in vols), cl.data_ptr(), cr.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), h,
        w, int(bool(subpixel)), int(bool(lr_check)), float(lr_max_diff),
        float(uniqueness_ratio), _stream())
    _build.check(rc, "sgm_wta")
    LAUNCHES["sgm_wta"] += 1
    return out
