"""Frozen copy of ``moving_object_detector_tpu_torch/ops/assignment.py`` at
fc97bde, the benchmark's plain reference: it imports nothing of the
port.

Assignment solver for data association (the JAX package's
``ops/assignment.py``).

The tracker's "gnn" mode: global nearest neighbour by optimal assignment,
the potential-based Hungarian algorithm (shortest augmenting paths).
Forbidden pairs (inf cost) take part as a large finite cost and are
filtered from the result, so the solver maximises the number of allowed
matches first and minimises their cost second.

Everything runs on the cost matrix's device without a host round trip:
the reference's ``while`` loops become loops of a fixed length with their
updates masked once the loop's condition has turned false. Row i's
augmenting path visits at most the i columns assigned so far plus one
free one, which bounds both inner loops by i + 1. The solver works on the
matrix with the smaller side as rows, unpadded: min(R, C) augmentations
over max(R, C) columns reach the same optimum as the reference's padded
square, whose extra rows only take up the columns left over at the
forbidden cost.
"""

from __future__ import annotations

import torch

# Small enough that f32 potential updates at this scale keep sub-unit
# cost differences (finite costs are normalised to [0, 1] first, which
# preserves the optimum).
_BIG = 1024.0
_INF = 1e18


def hungarian_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Optimal one-to-one assignment minimising the total cost.

    ``cost``: (R, C) f32, +inf marks forbidden pairs. Returns (R,) int32:
    the column assigned to each row, -1 for none."""
    r, c = cost.shape
    dev = cost.device
    cost = cost.detach().float()
    transposed = r > c
    a = cost.t() if transposed else cost
    nr, nc = a.shape
    finite = torch.isfinite(a)
    safe = torch.where(finite, a, torch.zeros_like(a))
    inf = torch.full_like(a, float("inf"))
    any_finite = finite.any()
    mn = torch.where(any_finite, torch.where(finite, safe, inf).min(),
                     torch.zeros((), device=dev))
    mx = torch.where(finite, safe, -inf).max()
    span = torch.where(any_finite, torch.clamp(mx - mn, min=1e-9),
                       torch.ones((), device=dev))
    sq = torch.where(finite, (safe - mn) / span,
                     torch.full_like(a, _BIG))

    # Potentials u (rows) and v (columns); p[j] = row of column j. Rows
    # and columns are 1-based, column 0 is the virtual start of each path.
    u = torch.zeros(nr + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(nc + 1, dtype=torch.float32, device=dev)
    p = torch.zeros(nc + 1, dtype=torch.long, device=dev)
    col_ids = torch.arange(nc + 1, device=dev)
    row_ids = torch.arange(nr + 1, device=dev)
    big = torch.full((nc,), _INF, dtype=torch.float32, device=dev)
    for i in range(nr):
        p[0] = i + 1
        minv = torch.full((nc + 1,), _INF, dtype=torch.float32, device=dev)
        used = torch.zeros(nc + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(nc + 1, dtype=torch.long, device=dev)
        j0 = torch.zeros((), dtype=torch.long, device=dev)
        for _ in range(i + 1):
            live = p[j0] != 0  # the path has not reached a free column
            used = used | (live & (col_ids == j0))
            i0 = p[j0]
            # Relax the unused columns through row i0's reduced costs.
            cur = sq[i0 - 1] - u[i0] - v[1:]
            better = live & ~used[1:] & (cur < minv[1:])
            minv[1:] = torch.where(better, cur, minv[1:])
            way[1:] = torch.where(better, j0, way[1:])
            masked = torch.where(used[1:], big, minv[1:])
            j1 = torch.argmin(masked) + 1
            delta = torch.where(live, masked[j1 - 1],
                                torch.zeros((), device=dev))
            # u[p[j]] += delta and v[j] -= delta over the used columns
            # (their rows are distinct), minv -= delta over the others.
            step = torch.where(used, delta, torch.zeros((), device=dev))
            u = u + (row_ids[:, None] == p[None, :]).float() @ step
            v = v - step
            minv = minv - torch.where(used, torch.zeros((), device=dev),
                                      delta)
            j0 = torch.where(live, j1, j0)
        # Unwind the augmenting path back to the virtual column.
        for _ in range(i + 1):
            j1 = way[j0]
            p[j0] = torch.where(j0 != 0, p[j1], p[j0])
            j0 = torch.where(j0 != 0, j1, j0)

    if transposed:  # a's columns are the rows of ``cost``
        match = p[1:] - 1
    else:
        row_to_col = torch.full((nr + 1,), -1, dtype=torch.long, device=dev)
        row_to_col[p[1:]] = col_ids[:nc]
        match = row_to_col[1:]
    picked = cost[torch.arange(r, device=dev), match.clamp(min=0)]
    ok = (match >= 0) & torch.isfinite(picked) & (picked < _BIG / 2)
    return torch.where(ok, match, torch.full_like(match, -1)).to(torch.int32)


# The name the tracker's "gnn" mode uses.
auction_assignment = hungarian_assignment
