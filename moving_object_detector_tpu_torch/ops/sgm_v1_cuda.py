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
# The cost kernel: pixels of a row a block takes, and its threads (a lane
# a pixel and 16 disparities).
COST_TX = 64
COST_THREADS = 128


def sw(i: int) -> int:
    """Word of right pixel ``i`` in the WTA's padded shared row: 4 pad
    words every 16."""
    return i + ((i >> 4) << 2)


def wta_smem_bytes(w: int) -> int:
    """Shared memory of a staged WTA block for a row of ``w`` pixels: the
    right view's packed minima padded by ``sw``, then the disparity."""
    return 4 * (sw(w - 1) + 1 + w)


# The widest row the WTA keeps in a block's shared memory; wider rows keep
# it in global memory.
WTA_SMEM_WIDTH = sgm_cuda._widest(wta_smem_bytes)
# The aggregation: steps a chunk of a warp's cost ring holds along the rows
# and along the columns, chunks a ring holds, lines a block (two warps
# each), and the largest P2 whose deltas (in [0, P2]) the staged variant
# keeps as bytes.
AGG_ROW_STEPS = 32
AGG_COL_STEPS = 8
AGG_RING_BUFS = 2
AGG_MAX_STRIP = 8
AGG_DELTA8_MAX_P2 = 255


def agg_smem_bytes(length: int, strip: int, vertical: bool,
                   staged: bool) -> int:
    """Shared memory of an aggregation block: each warp's ring (the column
    launch's staged variant rings the total beside the cost), then, staged,
    a byte delta a disparity for each cell of the strip's lines."""
    step = 3 * D if vertical and staged else D
    steps = AGG_COL_STEPS if vertical else AGG_ROW_STEPS
    ring = 2 * strip * AGG_RING_BUFS * steps * step
    return ring + (strip * length * D if staged else 0)


def agg_plan(h: int, w: int, p2: int, sms: int):
    """((strip, staged) of the row launch, (strip, staged) of the column
    launch) for an (h, w) volume on a card of ``sms`` SMs. A row launch
    block takes one row. A column launch block takes the fewest columns
    that let its blocks fit the SMs once, at most AGG_MAX_STRIP, and fewer
    where their deltas would not fit shared memory. Staged needs P2 <=
    AGG_DELTA8_MAX_P2 and a strip of one line to fit; otherwise a launch
    takes the read-modify-write variant."""
    lim = sgm_cuda.SMEM_PER_BLOCK
    small = p2 <= AGG_DELTA8_MAX_P2
    row = (1, small and agg_smem_bytes(w, 1, False, True) <= lim)
    strip = max(1, min(AGG_MAX_STRIP, -(-w // sms)))
    fit = strip
    while fit > 0 and agg_smem_bytes(h, fit, True, True) > lim:
        fit -= 1
    col = (fit, True) if small and fit > 0 else (strip, False)
    return row, col


def _widest(vertical: bool) -> int:
    n = 1
    while agg_smem_bytes(n + 1, 1, vertical, True) <= sgm_cuda.SMEM_PER_BLOCK:
        n += 1
    return n


# The longest rows and columns whose deltas a block stages; longer lines
# take the read-modify-write variant.
AGG_SMEM_WIDTH = _widest(False)
AGG_SMEM_HEIGHT = _widest(True)

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
        lib.sgm1_aggregate.argtypes = [_P, _P] + [_I] * 7 + [_P]
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
                    p2: int, vertical: bool, plan=None) -> None:
    """One launch of the aggregation kernel: both directions along the
    rows, storing into ``total``, or along the columns with ``vertical``,
    adding to it. ``plan`` overrides ``agg_plan``'s (strip, staged) of the
    launch, for timing it."""
    h, w = cost.shape[:2]
    if plan is None:
        sms = torch.cuda.get_device_properties(
            cost.device).multi_processor_count
        plan = agg_plan(h, w, p2, sms)[int(vertical)]
    strip, staged = plan
    _launched(_lib().sgm1_aggregate(cost.data_ptr(), total.data_ptr(), h, w,
                                    p1, p2, int(vertical), strip,
                                    int(staged), _stream()),
              "sgm1_aggregate")


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
    if cost.data_ptr() % 16:  # the kernel copies 16-byte pieces
        cost = cost.clone()
    h, w = cost.shape[:2]
    total = torch.empty((h, w, D), dtype=torch.int16, device=cost.device)
    _aggregate_pass(cost, total, p1, p2, vertical=False)
    _aggregate_pass(cost, total, p1, p2, vertical=True)
    return total


def wta(total: torch.Tensor, subpixel: bool = True, lr_check: bool = True,
        lr_max_diff: float = 1.0) -> torch.Tensor:
    """(H, W) f32 disparity (-1 invalid) from the int16 total; bitwise
    equal to ``sgm.wta_from_total(total, uniqueness_ratio=0)``."""
    if total.device.type == "cpu":
        return sgm.wta_from_total(total, subpixel, lr_check, lr_max_diff)
    total = _check_volume(total, torch.int16, "the aggregated total")
    if total.data_ptr() % 16:  # the kernel reads 16-byte pieces
        total = total.clone()
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
