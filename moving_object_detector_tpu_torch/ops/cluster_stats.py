"""Per-cluster statistics after connected components, plain PyTorch form
(the JAX package's unrolled masked passes in ``clusterer.py``).

For each of the ``cap`` selected roots: the compact-id image, the AABB of
the cluster's points and its member count. This is the plain version of
the CUDA kernel in ``csrc/cluster_stats.cu``.
"""

from __future__ import annotations

import torch


def cluster_stats(labels: torch.Tensor, points: torch.Tensor,
                  roots: torch.Tensor):
    """``labels`` (h, w) int32 CC labels (h*w = background), ``points``
    (h, w, 3) f32, ``roots`` (cap,) int32 selected root labels with h*w in
    unused slots, distinct otherwise. Returns

    cid   (h, w) int32 in [0, cap], cap = background or unselected;
    mins, maxs (cap, 3) f32 AABB corners (+inf / -inf for an empty slot);
    csize (cap,) int32 member counts.

    ``cap`` masked passes for the ids and ``cap`` masked reductions for
    the boxes. A NaN coordinate of a member pixel makes that slot's min
    and max NaN."""
    h, w = labels.shape
    n = h * w
    cap = roots.shape[0]
    dev = labels.device
    flat_labels = labels.reshape(-1)
    root_valid = roots < n
    cid = torch.full((n,), cap, dtype=torch.int32, device=dev)
    for c in range(cap):
        cid = torch.where(root_valid[c] & (flat_labels == roots[c]),
                          torch.tensor(c, dtype=torch.int32, device=dev), cid)
    pts = points.reshape(n, 3)
    mins, maxs, csize = [], [], []
    inf = float("inf")
    for c in range(cap):
        in_c = (cid == c)[:, None]
        mins.append(torch.where(in_c, pts, inf).amin(dim=0))
        maxs.append(torch.where(in_c, pts, -inf).amax(dim=0))
        csize.append(in_c.sum(dtype=torch.int32))
    return (cid.reshape(h, w), torch.stack(mins), torch.stack(maxs),
            torch.stack(csize))
