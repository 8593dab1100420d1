"""Depth-gated connected components on organized clouds (the JAX
package's label-propagation form, ``ops/clustering.py``).

Pixels p and q are adjacent iff both are dynamic, |z_p - z_q| <=
depth_diff, and q - p is a sign-consistent offset within the radius.
Each iteration takes the minimum label over the direct edges, then runs
segmented min-scans along rows and columns over the 4-neighbour edges;
iterating to a fixed point gives the exact partition. Labels are the
component's smallest flat index, background H*W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _edge_offsets(k: int):
    """Sign-consistent offsets within the (k+1)^2 window, without (0, 0)."""
    return tuple((dv, du) for dv in range(-k, k + 1)
                 for du in range(-k, k + 1)
                 if not (du == 0 and dv == 0) and du * dv >= 0)


def _shift2d(x: torch.Tensor, dv: int, du: int, fill):
    """out[v, u] = x[v + dv, u + du] where in bounds, else ``fill``."""
    h, w = x.shape
    pv, pu = abs(dv), abs(du)
    if x.dtype == torch.bool:
        padded = F.pad(x.to(torch.uint8), (pu, pu, pv, pv),
                       value=int(fill)).bool()
    else:
        padded = F.pad(x, (pu, pu, pv, pv), value=fill)
    return padded[pv + dv: pv + dv + h, pu + du: pu + du + w]


def _seg_min_scan(label, barrier, dim: int, reverse: bool):
    """Segmented inclusive min-scan along ``dim``: ``barrier`` at a
    position stops the carry from the previous position. Hillis-Steele
    doubling, O(log n) steps."""
    if reverse:
        label = torch.flip(label, (dim,))
        barrier = torch.flip(barrier, (dim,))
    m, b = label, barrier
    n = label.shape[dim]
    step = 1
    while step < n:
        m_prev = torch.narrow(m, dim, 0, n - step)
        b_prev = torch.narrow(b, dim, 0, n - step)
        m_cur = torch.narrow(m, dim, step, n - step)
        b_cur = torch.narrow(b, dim, step, n - step)
        new_m = torch.where(b_cur, m_cur, torch.minimum(m_prev, m_cur))
        new_b = b_cur | b_prev
        m = torch.cat([torch.narrow(m, dim, 0, step), new_m], dim=dim)
        b = torch.cat([torch.narrow(b, dim, 0, step), new_b], dim=dim)
        step *= 2
    return torch.flip(m, (dim,)) if reverse else m


def connected_components(dynamic, depth, depth_diff, neighbor_distance=4,
                         max_iters: int = 64, stencil_radius=None):
    """(H, W) int32 labels of the dynamic-pixel graph (see module doc).

    ``neighbor_distance`` may be a 0-d tensor up to ``stencil_radius``.
    The fixed-point loop is a Python loop bounded by ``max_iters``; its
    convergence test fetches one flag per iteration. Each fetch is a host
    sync: the host waits for the iteration's few hundred small kernels
    before it launches the next ones, so the card idles for the launch
    latency of every iteration (the clusterer stage's time is in
    PERF.md)."""
    if stencil_radius is None:
        if not isinstance(neighbor_distance, int):
            raise TypeError(
                "a tensor neighbor_distance requires a stencil_radius")
        stencil_radius = neighbor_distance
    h, w = dynamic.shape
    dev = dynamic.device
    n = h * w
    sentinel = torch.tensor(n, dtype=torch.int32, device=dev)
    flat_idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(h, w)
    label = torch.where(dynamic, flat_idx, sentinel)
    nd = torch.clamp(torch.as_tensor(neighbor_distance, dtype=torch.int32,
                                     device=dev), 0, stencil_radius)
    inf = float("inf")
    z = torch.where(dynamic & torch.isfinite(depth), depth,
                    torch.full_like(depth, inf))

    offsets = _edge_offsets(stencil_radius)
    edge_masks = []
    for dv, du in offsets:
        nz = _shift2d(z, dv, du, inf)
        ndyn = _shift2d(dynamic, dv, du, False)
        in_radius = max(abs(dv), abs(du)) <= nd
        edge_masks.append(dynamic & ndyn & ((z - nz).abs() <= depth_diff)
                          & in_radius)

    def sweep(lab):
        best = lab
        for (dv, du), ok in zip(offsets, edge_masks):
            neigh = _shift2d(lab, dv, du, n)
            best = torch.minimum(best, torch.where(ok, neigh, sentinel))
        return best

    adj_h = (dynamic & _shift2d(dynamic, 0, -1, False)
             & ((z - _shift2d(z, 0, -1, inf)).abs() <= depth_diff)
             & (nd >= 1))
    adj_v = (dynamic & _shift2d(dynamic, -1, 0, False)
             & ((z - _shift2d(z, -1, 0, inf)).abs() <= depth_diff)
             & (nd >= 1))
    bar_l = ~adj_h
    bar_r = ~_shift2d(adj_h, 0, 1, False)
    bar_u = ~adj_v
    bar_d = ~_shift2d(adj_v, 1, 0, False)

    def propagate(lab):
        lab = _seg_min_scan(lab, bar_l, 1, False)
        lab = _seg_min_scan(lab, bar_r, 1, True)
        lab = _seg_min_scan(lab, bar_u, 0, False)
        lab = _seg_min_scan(lab, bar_d, 0, True)
        return torch.where(dynamic, lab, sentinel)

    for _ in range(max_iters):
        new = propagate(sweep(label))
        changed = bool((new != label).any())
        label = new
        if not changed:
            break
    return label
