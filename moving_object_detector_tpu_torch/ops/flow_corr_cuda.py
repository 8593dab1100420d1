"""Wrappers of the PWC-Net correlation CUDA kernels (``csrc/corr.cu``,
``csrc/corr_bwd.cu``) and the differentiable correlation built on them.

Replaces the JAX package's Pallas kernel ``correlation_pallas``
(``ops/flow_corr_pallas.py``), a custom VJP whose backward
differentiates the XLA form. Here ``correlation`` is a
``torch.autograd.Function``: on CUDA tensors its forward launches
``corr_forward`` and its backward ``corr_backward``, each adding one to
its count in ``LAUNCHES`` ("corr", "corr_backward"); on CPU tensors both
directions run the plain versions ``flow_ops.correlation`` and
``flow_ops.correlation_backward``. A failed build or launch raises;
nothing falls back to autograd through the plain form on a CUDA tensor.
Inside a CUDA graph's capture ``corr_forward`` is a cut point
(``utils/cuda_graphs.py``): each replay launches it between the graphs.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from ..utils import cuda_graphs
from . import flow_ops

LAUNCHES = {"corr": 0, "corr_backward": 0}
MAX_GRID = 65535  # blocks along a grid's second and third dimension
_typed = set()

# ``csrc/corr_bwd.cu``'s tiling constants (the tests hold them equal).
BWD_PIXELS = 4  # kP: pixels a thread
BWD_CHANNELS = 2  # kCh: channels a thread a round
BWD_HALO = 4  # kHalo
BWD_STAGES = 2  # kStages
BWD_MAX_TX = 32  # kMaxTX
BWD_ROWS = 2  # kRows
BWD_MAX_TY = 4  # kMaxTY
BWD_SHORT_H = 8  # kShortH
BWD_MAX_SLOTS = 16  # kMaxSlots
BWD_MAX_THREADS = 512  # kMaxThreads
BWD_MIN_BLOCKS = 132  # kMinBlocks
BWD_TARGET_BLOCKS = 264  # kTargetBlocks
BWD_SMEM_TARGET = 114688  # kSmemTarget, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _window_floats(wrows: int, rs: int, slots: int) -> int:
    want = 1 if slots >= 8 else 8 // slots % 8
    words = wrows * rs // 4
    while words % 8 != want:
        words += 1
    return 4 * words


def _bwd_smem(tx: int, ty: int, slots: int, chs: int, kk: int) -> int:
    return 4 * (ty * kk * tx + BWD_STAGES * slots * BWD_CHANNELS * chs)


def backward_plan(b: int, c: int, h: int, w: int, r: int,
                  vec: bool) -> dict:
    """The launch ``corr_backward`` makes for a (b, c, h, w) call at
    search range r (``vec``: 16-byte copies), as ``plan`` in
    ``csrc/corr_bwd.cu`` picks it: the tile (tx, ty), the channel slots,
    the grid's tiles, row groups and channel chunks, the rounds a block,
    the floats of a channel's window, and the block's threads, shared
    bytes and the grid's blocks."""
    kk = (2 * r + 1) ** 2
    tiles = _cdiv(w, BWD_MAX_TX)
    tx = _cdiv(_cdiv(w, tiles), BWD_PIXELS) * BWD_PIXELS
    groups = _cdiv(h, BWD_MAX_TY if h < BWD_SHORT_H else BWD_ROWS)
    ty = _cdiv(h, groups)
    npg = tx // BWD_PIXELS
    rs = tx + 2 * BWD_HALO
    wrows = ty + 2 * r
    per_chunk = 2 * tiles * groups * b
    slots = BWD_MAX_SLOTS
    while slots > 1 and (
            slots * npg * ty > BWD_MAX_THREADS
            or _bwd_smem(tx, ty, slots, _window_floats(wrows, rs, slots),
                         kk) > BWD_SMEM_TARGET):
        slots //= 2
    while slots > 1 and (per_chunk * _cdiv(c, BWD_CHANNELS * slots)
                         < BWD_MIN_BLOCKS):
        slots //= 2
    need = max(tx, rs // (4 if vec else 1))
    while slots * npg * ty < need:
        slots *= 2
    total = _cdiv(c, BWD_CHANNELS * slots)
    chunks = min(_cdiv(BWD_TARGET_BLOCKS, per_chunk), total)
    rounds = _cdiv(total, chunks)
    chunks = _cdiv(total, rounds)
    chs = _window_floats(wrows, rs, slots)
    return dict(tx=tx, ty=ty, slots=slots, tiles=tiles, groups=groups,
                chunks=chunks, rounds=rounds, chs=chs,
                threads=slots * npg * ty,
                smem=_bwd_smem(tx, ty, slots, chs, kk),
                blocks=per_chunk * chunks)


def _lib(name: str):
    lib = _build.load(name)
    if name not in _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "corr":
            lib.corr_forward.argtypes = [P, P, P, I, I, I, I, I, P]
            lib.corr_forward.restype = I
        else:
            lib.corr_backward.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
            lib.corr_backward.restype = I
        _typed.add(name)
    return lib


def _kernel_inputs(f1: torch.Tensor, f2: torch.Tensor, search_range: int,
                   g: torch.Tensor | None = None) -> tuple:
    """The kernels' refusals, for any tensor not on the CPU; returns the
    inputs made contiguous."""
    tensors = (f1, f2) if g is None else (f1, f2, g)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the correlation kernels take f32 inputs")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"shapes {tuple(f1.shape)} / {tuple(f2.shape)} "
                         "must be equal (B, C, H, W)")
    if not 1 <= search_range <= 4:
        raise ValueError(f"search_range {search_range}: the kernels are "
                         "built for 1..4")
    b, c, h, w = f1.shape
    if min(b, c, h, w) < 1 or h > MAX_GRID or b > MAX_GRID:
        raise ValueError(f"shape {tuple(f1.shape)}: the kernels take "
                         f"non-empty inputs with B, H <= {MAX_GRID} (their "
                         "grid is tiles x H x B)")
    if g is not None and tuple(g.shape) != (b, (2 * search_range + 1) ** 2,
                                           h, w):
        raise ValueError(f"gradient shape {tuple(g.shape)} is not the "
                         f"output's ({b}, {(2 * search_range + 1) ** 2}, "
                         f"{h}, {w})")
    if any(t.device.type != "cuda" or t.device != f1.device
           for t in tensors):
        raise ValueError("correlation inputs must be CUDA tensors on one "
                         "device")
    return tuple(t.contiguous() for t in tensors)


def corr_forward(f1: torch.Tensor, f2: torch.Tensor,
                 search_range: int = 4,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, C, H, W) f32 pair -> (B, (2r+1)^2, H, W) f32 mean-channel local
    cost volume, dy-major offsets, zero outside the image, written into
    ``out`` where given. The kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        corr = flow_ops.correlation(f1, f2, search_range)
        return corr if out is None else out.copy_(corr)
    f1, f2 = _kernel_inputs(f1, f2, search_range)
    b, c, h, w = f1.shape
    shape = (b, (2 * search_range + 1) ** 2, h, w)
    cut = cuda_graphs.cut_point(__name__, "corr_forward",
                                (f1, f2, search_range), shape, torch.float32,
                                f1.device)
    if cut is not None:
        return cut
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=f1.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.device != f1.device or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}: the kernel writes a contiguous "
                         f"{shape} f32 on {f1.device}")
    rc = _lib("corr").corr_forward(f1.data_ptr(), f2.data_ptr(),
                                   out.data_ptr(), b, c, h, w, search_range,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "corr_forward")
    LAUNCHES["corr"] += 1
    return out


def corr_backward(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                  search_range: int = 4):
    """Gradients (g1, g2) of the correlation with respect to ``f1`` and
    ``f2`` given the output's gradient ``g``. One kernel launch for both
    on CUDA tensors, the plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (f1, f2, g)):
        return flow_ops.correlation_backward(f1, f2, g, search_range)
    f1, f2, g = _kernel_inputs(f1, f2, search_range, g)
    b, c, h, w = f1.shape
    g1 = torch.empty_like(f1)
    g2 = torch.empty_like(f2)
    rc = _lib("corr_bwd").corr_backward(
        f1.data_ptr(), f2.data_ptr(), g.data_ptr(), g1.data_ptr(),
        g2.data_ptr(), b, c, h, w, search_range,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "corr_backward")
    LAUNCHES["corr_backward"] += 1
    return g1, g2


class _Correlation(torch.autograd.Function):
    """The correlation with the hand-written backward."""

    @staticmethod
    def forward(ctx, f1, f2, search_range):
        ctx.search_range = search_range
        ctx.save_for_backward(f1, f2)
        return corr_forward(f1, f2, search_range)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        g1, g2 = corr_backward(f1, f2, g, ctx.search_range)
        return g1, g2, None


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                search_range: int = 4) -> torch.Tensor:
    """(B, C, H, W) f32 pair -> (B, (2r+1)^2, H, W) f32 mean-channel local
    cost volume, dy-major offsets, zero outside the image; differentiable
    in both inputs (``corr_backward``)."""
    return _Correlation.apply(f1, f2, search_range)
