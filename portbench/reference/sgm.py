"""Frozen copy of ``moving_object_detector_tpu_torch/ops/sgm.py`` at
fc97bde (the serving kernels' plain versions only), the benchmark's
plain reference: it imports nothing of the port.

Semi-global matching stereo (the JAX package's ``ops/sgm.py`` and the
contracts of its two kernel generations, ``ops/sgm_pallas2.py`` (v2) and
``ops/sgm_pallas.py`` (v1)).

Census transform, Hamming matching cost, 4- or 8-path DP aggregation and
the winner-take-all with parabola subpixel, optional uniqueness and the
left-right check. The aggregation is expressed as the v2 kernels express
it: each direction emits path deltas ``m(d) - min L`` in [0, P2] with
L = C + delta. The v2 kernels store the four int8 delta volumes and the
WTA recomputes C from the census; the v1 kernels read a stored cost
volume and sum L itself into an int16 total (``aggregate_cost_volume``).
Every volume here is (H, W, D) with D contiguous, the layout of the CUDA
kernels in ``sgm_cuda.py`` and ``sgm_v1_cuda.py``; the functions in this
module are those kernels' plain versions and run on any device.
"""

from __future__ import annotations

import torch

from .config import SGMConfig
from .types import DisparityImage, StereoModel

MAX_COST = 32  # cost of a candidate beyond the left image edge (x < d)
_BIG = 1 << 20


def census_transform(img: torch.Tensor, window=(5, 5)) -> torch.Tensor:
    """Bit i is set where window neighbour i is darker than the centre
    (neighbours outside the image never are). (H, W) -> (H, W) int32."""
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0 or wh * ww - 1 > 32:
        raise ValueError(f"census window {window}: both sides odd and at "
                         "most 32 neighbours (the signature is int32)")
    rh, rw = wh // 2, ww // 2
    img = img.float()
    pad = torch.nn.functional.pad(img[None, None], (rw, rw, rh, rh),
                                  value=float("inf"))[0, 0]
    h, w = img.shape
    out = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    i = 0
    for dy in range(-rh, rh + 1):
        for dx in range(-rw, rw + 1):
            if dy == 0 and dx == 0:
                continue
            neigh = pad[rh + dy: rh + dy + h, rw + dx: rw + dx + w]
            out |= (neigh < img).to(torch.int32) << i
            i += 1
    return out


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_cost(census_l: torch.Tensor, census_r: torch.Tensor,
                 max_disparity: int) -> torch.Tensor:
    """(H, W, D) int32 cost popcount(cl(x) ^ cr(x - d)), MAX_COST for
    x < d."""
    h, w = census_l.shape
    crp = torch.nn.functional.pad(census_r, (max_disparity, 0))
    cost = torch.empty((h, w, max_disparity), dtype=torch.int32,
                       device=census_l.device)
    cols = torch.arange(w, device=census_l.device)[None, :]
    for d in range(max_disparity):
        shifted = crp[:, max_disparity - d: max_disparity - d + w]
        ham = _popcount32(census_l ^ shifted).to(torch.int32)
        cost[:, :, d] = torch.where(cols < d, MAX_COST, ham)
    return cost


def _dp_deltas(cost: torch.Tensor, p1: int, p2: int, reverse: bool,
               dx: int = 0, dtype=torch.int8):
    """One DP direction scanning axis 0 of ``cost`` (S, N, D): returns the
    (S, N, D) deltas of ``_dp_update_sub`` (ops/sgm_pallas2.py) as
    ``dtype``. ``dx`` = 1 / -1 makes the scan diagonal: line n's
    predecessor is line n - dx of the previous step, and a line without a
    predecessor starts from a zero carry (delta 0, L = C)."""
    s, n, d = cost.shape
    out = torch.empty((s, n, d), dtype=dtype, device=cost.device)
    carry = torch.zeros((n, d), dtype=torch.int32, device=cost.device)
    big = torch.full((n, 1), _BIG, dtype=torch.int32, device=cost.device)
    zero = torch.zeros((1, d), dtype=torch.int32, device=cost.device)
    for i in range(s):
        t = s - 1 - i if reverse else i
        prev_min = carry.min(dim=1, keepdim=True).values
        dm1 = torch.cat([big, carry[:, :-1]], dim=1)
        dp1 = torch.cat([carry[:, 1:], big], dim=1)
        best = torch.minimum(torch.minimum(carry, prev_min + p2),
                             torch.minimum(dm1, dp1) + p1)
        delta = best - prev_min
        out[t] = delta.to(dtype)
        carry = cost[t] + delta
        if dx == 1:
            carry = torch.cat([zero, carry[:-1]], dim=0)
        elif dx == -1:
            carry = torch.cat([carry[1:], zero], dim=0)
    return out


def _check_penalties(p1: int, p2: int):
    if p1 < 0:
        raise ValueError(f"P1={p1}: path costs need P1 >= 0")
    if not 0 <= p2 <= 127:
        raise ValueError(f"P2={p2}: int8 path deltas need 0 <= P2 <= 127")


def vertical_deltas(census_l, census_r, p1: int, p2: int,
                    max_disparity: int = 128):
    """Plain version of the vertical DP kernel: (vf, vb), each (H, W, D)
    int8, for the top-down and bottom-up directions."""
    _check_penalties(p1, p2)
    cost = hamming_cost(census_l, census_r, max_disparity)
    return (_dp_deltas(cost, p1, p2, False), _dp_deltas(cost, p1, p2, True))


def horizontal_deltas(census_l, census_r, p1: int, p2: int,
                      max_disparity: int = 128):
    """Plain version of the horizontal DP kernel: (hf, hb), each (H, W, D)
    int8, for the left-right and right-left directions."""
    _check_penalties(p1, p2)
    cost = hamming_cost(census_l, census_r, max_disparity).transpose(0, 1)
    hf = _dp_deltas(cost, p1, p2, False).transpose(0, 1)
    hb = _dp_deltas(cost, p1, p2, True).transpose(0, 1)
    return hf, hb


def total_from_deltas(hf, hb, vf, vb, census_l, census_r) -> torch.Tensor:
    """(H, W, D) int32 aggregated 4-path total: sum of deltas + 4 C."""
    d = hf.shape[-1]
    cost = hamming_cost(census_l, census_r, d)
    return (hf.to(torch.int32) + hb.to(torch.int32) + vf.to(torch.int32)
            + vb.to(torch.int32) + 4 * cost)


def aggregate_diagonal(cost: torch.Tensor, dx: int, reverse: bool, p1: int,
                       p2: int) -> torch.Tensor:
    """Aggregated path cost L along one diagonal of an (H, W, D) cost
    volume: a row scan in which pixel (y, x) follows (y -+ 1, x - dx).
    (H, W, D) int32."""
    cost = cost.to(torch.int32)
    return cost + _dp_deltas(cost, p1, p2, reverse, dx=dx,
                             dtype=torch.int32)


def aggregate_cost_volume(cost: torch.Tensor, p1: int, p2: int,
                          num_paths: int = 4) -> torch.Tensor:
    """Sum of the directional path costs L = C + delta over a stored
    (H, W, D) int8 / int32 cost volume: 4 paths (horizontal and vertical,
    both ways) or 8 (the diagonals too). Costs are clipped to [0, 127] on
    read. (H, W, D) int16; the plain version of the v1 aggregation
    kernel."""
    if num_paths not in (4, 8):
        raise ValueError(f"SGMConfig.num_paths must be 4 or 8, got "
                         f"{num_paths}")
    if not (p2 >= 0 and num_paths * (127 + p2) < 32768):
        raise ValueError(f"P2={p2}: {num_paths} path sums of up to "
                         "127 + P2 must fit int16")
    c = cost.to(torch.int32).clamp(0, 127)
    ct = c.transpose(0, 1)
    total = 4 * c
    for rev in (False, True):
        total += _dp_deltas(ct, p1, p2, rev,
                            dtype=torch.int32).transpose(0, 1)
        total += _dp_deltas(c, p1, p2, rev, dtype=torch.int32)
    if num_paths == 8:
        for dx in (1, -1):
            for rev in (False, True):
                total += aggregate_diagonal(c, dx, rev, p1, p2)
    return total.to(torch.int16)


def wta_from_total(total: torch.Tensor, subpixel: bool = True,
                   lr_check: bool = True, lr_max_diff: float = 1.0,
                   uniqueness_ratio: float = 0.0) -> torch.Tensor:
    """Winner-take-all on an (H, W, D) integer total: left argmin (lowest
    d wins ties), parabola subpixel, optional uniqueness, right-view
    argmin and the LR check. (H, W) f32, -1 where invalid."""
    h, w, d = total.shape
    dev = total.device
    total = total.to(torch.int32)
    d_iota = torch.arange(d, dtype=torch.int32, device=dev)
    packed = total * d + d_iota
    run = packed.min(dim=-1).values
    best = run % d
    c0 = (run // d).float()
    big = torch.tensor(1 << 30, dtype=torch.int32, device=dev)
    best_l = best.long()[..., None]
    cm = total.gather(-1, (best_l - 1).clamp(min=0))[..., 0].float()
    cp = total.gather(-1, (best_l + 1).clamp(max=d - 1))[..., 0].float()
    disp = best.float()
    if subpixel:
        denom = cm - 2.0 * c0 + cp
        offset = torch.where(
            denom > 1e-6, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-6),
            torch.zeros_like(denom))
        interior = (best > 0) & (best < d - 1)
        disp = disp + torch.where(interior, offset, torch.zeros_like(offset))
    x = torch.arange(w, device=dev)[None, :]
    valid = x >= best
    if uniqueness_ratio > 0:
        excl = (d_iota - best[..., None]).abs() <= 1
        umin = torch.where(excl, big, total).min(dim=-1).values.float()
        ratio = torch.tensor(uniqueness_ratio, dtype=torch.float32,
                             device=dev)
        valid = valid & (umin * ratio >= c0)
    if lr_check:
        # Right view: cost_R(y, xr, d) = total(y, xr + d, d).
        src = (torch.arange(w, device=dev)[:, None]
               + d_iota.long()[None, :])  # (W, D)
        right = _right_view_packed(packed, src, src < w, big)
        best_r = right % d
        xr = torch.round(x.float() - disp).to(torch.int64)
        d_r = best_r.gather(1, xr.clamp(0, w - 1))
        consistent = (disp - d_r.float()).abs() <= lr_max_diff
        valid = valid & (xr >= 0) & consistent
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def _right_view_packed(packed, src, in_img, big):
    """(H, W) min over d of packed(y, xr + d, d), candidates beyond the
    image excluded."""
    h, w, d = packed.shape
    flat = packed.reshape(h, w * d)
    idx = (src.clamp(max=w - 1) * d
           + torch.arange(d, device=packed.device)[None, :])  # (W, D)
    vals = flat[:, idx.reshape(-1)].reshape(h, w, d)
    vals = torch.where(in_img[None], vals, big)
    return vals.min(dim=-1).values


def sgm_disparity_raw(left: torch.Tensor, right: torch.Tensor,
                      cfg: SGMConfig = SGMConfig()) -> torch.Tensor:
    """(H, W) pair -> (H, W) f32 disparity, -1 invalid, by the plain
    versions of the serving kernels: census, the vertical and horizontal
    path deltas, their total and the winner-take-all."""
    left = left.float()
    right = right.float()
    if cfg.num_paths != 4:
        raise ValueError(f"num_paths={cfg.num_paths}: the serving SGM "
                         "aggregates the 4 h/v paths")
    cl = census_transform(left, cfg.census_window)
    cr = census_transform(right, cfg.census_window)
    kw = dict(p1=int(cfg.p1), p2=int(cfg.p2),
              max_disparity=int(cfg.max_disparity))
    vf, vb = vertical_deltas(cl, cr, **kw)
    hf, hb = horizontal_deltas(cl, cr, **kw)
    return wta_from_total(
        total_from_deltas(hf, hb, vf, vb, cl, cr),
        subpixel=cfg.subpixel, lr_check=cfg.lr_check,
        lr_max_diff=float(cfg.lr_max_diff),
        uniqueness_ratio=float(cfg.uniqueness_ratio))


def disparity_with_metadata(disp: torch.Tensor, stereo: StereoModel,
                            cfg: SGMConfig) -> DisparityImage:
    """Wrap a raw disparity map with f / T / [0, D-1] metadata."""
    return DisparityImage.create(
        disp, f=stereo.cam.fx, t=stereo.baseline, min_disparity=0.0,
        max_disparity=float(cfg.max_disparity - 1))


def compute_disparity(left, right, stereo: StereoModel,
                      cfg: SGMConfig = SGMConfig()) -> DisparityImage:
    """Full SGM stereo: (H, W) grayscale pair -> DisparityImage."""
    return disparity_with_metadata(sgm_disparity_raw(left, right, cfg),
                                   stereo, cfg)
