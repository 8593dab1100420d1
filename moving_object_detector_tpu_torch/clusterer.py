"""Detection stage (the JAX package's ``clusterer.py``): dynamic map,
depth-gated connected components, size filter, per-cluster AABB and
descending-norm median velocity, with a fixed object capacity.

The JAX ``lax.cond`` branches (quiet frame, one crop window, two windows
split at the widest static column gap, full frame) become Python ``if``s
on flags fetched from the device. Clusters are ordered by the raster
index of their first member pixel. Cluster statistics use the XLA form
(``cc_backend="xla"``): ``cap`` masked reductions.
"""

from __future__ import annotations

import torch

from .config import ClustererConfig
from .ops.clustering import connected_components
from .types import MovingObjects, SceneFlowCloud


def cluster_scene_flow(cloud: SceneFlowCloud,
                       config: ClustererConfig = ClustererConfig(),
                       dynamic_speed=None, depth_diff=None,
                       cluster_size=None, neighbor_distance=None,
                       return_overflow: bool = False):
    """Cluster dynamic pixels into moving objects: (MovingObjects,
    (H, W) int32 slot-index label image with -1 background[, overflow])
    where overflow counts size-passing clusters beyond ``max_objects``."""
    dev = cloud.points.device

    def t(v, default, dtype):
        return torch.as_tensor(default if v is None else v, dtype=dtype,
                               device=dev)

    dynamic_speed = t(dynamic_speed, config.dynamic_speed, torch.float32)
    depth_diff = t(depth_diff, config.depth_diff, torch.float32)
    cluster_size = t(cluster_size, config.cluster_size, torch.int32)
    neighbor_distance = t(neighbor_distance, config.neighbor_distance,
                          torch.int32)
    h, w = cloud.points.shape[:2]
    cap = config.max_objects
    kwargs = dict(config=config, dynamic_speed=dynamic_speed,
                  depth_diff=depth_diff, cluster_size=cluster_size,
                  neighbor_distance=neighbor_distance)

    vel = cloud.velocity
    vnorm = torch.sqrt((vel * vel).sum(-1))
    dynamic = vnorm >= dynamic_speed

    result = _cluster_frame(cloud, vel, vnorm, dynamic, h, w, cap, kwargs)
    if return_overflow:
        return result
    return result[:2]


def _empty(h, w, cap, dev):
    return (MovingObjects.empty(cap, dev),
            torch.full((h, w), -1, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def _cluster_frame(cloud, vel, vnorm, dynamic, h, w, cap, kwargs):
    config = kwargs["config"]
    dev = vel.device
    rows_any = dynamic.any(dim=1)
    cols_any = dynamic.any(dim=0)
    ri = torch.arange(h, dtype=torch.int32, device=dev)
    ci = torch.arange(w, dtype=torch.int32, device=dev)
    masked = lambda m, v, fill: torch.where(m, v, torch.full_like(v, fill))
    # One fetch of the dynamic extent decides the branch (r1 < 0: quiet).
    r0, r1, c0, c1 = torch.stack([
        masked(rows_any, ri, h).min(), masked(rows_any, ri, -1).max(),
        masked(cols_any, ci, w).min(), masked(cols_any, ci, -1).max(),
    ]).tolist()
    if r1 < 0:  # quiet frame: no dynamic pixel
        return _empty(h, w, cap, dev)

    def full():
        return _cluster_dynamic(cloud, vel, vnorm, dynamic, **kwargs)[:3]

    ch = min(config.cc_crop_h, h) if config.cc_crop_h > 0 else 0
    cw = min(config.cc_crop_w, w) if config.cc_crop_w > 0 else 0
    if not (ch > 0 and cw > 0 and (ch < h or cw < w)):
        return full()

    def run_window(dyn_src, r0s, c0s):
        """Cluster one (ch, cw) window; also return each slot's frame
        raster root key and the window's size-passing cluster count."""
        sl = (slice(r0s, r0s + ch), slice(c0s, c0s + cw))
        objects, label_c, overflow, roots = _cluster_dynamic(
            SceneFlowCloud(points=cloud.points[sl], velocity=vel[sl]),
            vel[sl], vnorm[sl], dyn_src[sl], min_size_cap=h * w, **kwargs)
        nc = ch * cw
        key = torch.where(roots < nc,
                          (roots // cw + r0s) * w + (roots % cw + c0s),
                          torch.full_like(roots, h * w))
        n_big = (roots < nc).sum().to(torch.int32) + overflow
        return objects, label_c, overflow, key, n_big

    if r1 - r0 < ch and c1 - c0 < cw:
        r0c = min(max(r0, 0), h - ch)
        c0c = min(max(c0, 0), w - cw)
        objects, label_c, overflow, _, _ = run_window(dynamic, r0c, c0c)
        label_image = torch.full((h, w), -1, dtype=torch.int32, device=dev)
        label_image[r0c: r0c + ch, c0c: c0c + cw] = label_c
        return objects, label_image, overflow
    if config.cc_crop_windows < 2:
        return full()

    # Two windows split at the widest all-static column gap: exact when the
    # gap exceeds the neighbour radius (no edge crosses it).
    dyncol = torch.where(cols_any, ci, torch.full_like(ci, -1))
    last_dyn = torch.cummax(dyncol, dim=0).values
    prev_dyn = torch.cat([last_dyn.new_full((1,), -1), last_dyn[:-1]])
    gap = torch.where(cols_any & (prev_dyn >= 0), ci - prev_dyn - 1,
                      torch.full_like(ci, -1))
    i_star = torch.argmax(gap)  # right side's first column
    c_l = prev_dyn[i_star]  # left side's last column
    colmask_l = (ci <= c_l)[None, :]
    dyn_l = dynamic & colmask_l
    dyn_r = dynamic & ~colmask_l
    rl, rr = dyn_l.any(dim=1), dyn_r.any(dim=1)
    i_star, c_l, r0l, r1l, r0r, r1r, nd = torch.stack([
        i_star.to(torch.int32), c_l, masked(rl, ri, h).min(),
        masked(rl, ri, -1).max(), masked(rr, ri, h).min(),
        masked(rr, ri, -1).max(), kwargs["neighbor_distance"]]).tolist()
    fits2 = (c_l >= 0 and i_star - c_l > nd
             and r1l - r0l < ch and c_l - c0 < cw
             and r1r - r0r < ch and c1 - i_star < cw)
    if not fits2:
        return full()
    r0lc, c0lc = min(max(r0l, 0), h - ch), min(max(c0, 0), w - cw)
    r0rc, c0rc = min(max(r0r, 0), h - ch), min(max(i_star, 0), w - cw)
    obj_l, lab_l, _, key_l, big_l = run_window(dyn_l, r0lc, c0lc)
    obj_r, lab_r, _, key_r, big_r = run_window(dyn_r, r0rc, c0rc)
    # Merge the windows' slots in global root order, keep the first cap.
    allkey = torch.cat([key_l, key_r])
    full_order = torch.sort(allkey, stable=True).indices
    rank = torch.empty_like(full_order)
    rank[full_order] = torch.arange(2 * cap, device=dev)
    order = full_order[:cap]

    def pick(a, b):
        return torch.cat([a, b])[order]

    valid_m = pick(obj_l.valid, obj_r.valid)
    ids_m = torch.where(valid_m, torch.cumsum(valid_m.to(torch.int32), 0) - 1,
                        torch.full_like(valid_m, -1, dtype=torch.int32))
    objects = MovingObjects(
        id=ids_m.to(torch.int32),
        center=pick(obj_l.center, obj_r.center),
        velocity=pick(obj_l.velocity, obj_r.velocity),
        bounding_box=pick(obj_l.bounding_box, obj_r.bounding_box),
        valid=valid_m)
    # Window-compact id -> merged slot index (-1 beyond capacity).
    lut = torch.where(rank < cap, rank, torch.full_like(rank, -1)).to(
        torch.int32)

    def remap(lab, lut_side):
        table = torch.cat([lut_side, lut_side.new_full((1,), -1)])
        return table[torch.where(lab >= 0, lab, cap).long()]

    label_image = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    t_l = label_image.clone()
    t_l[r0lc: r0lc + ch, c0lc: c0lc + cw] = remap(lab_l, lut[:cap])
    label_image[r0rc: r0rc + ch, c0rc: c0rc + cw] = remap(lab_r, lut[cap:])
    label_image = torch.maximum(t_l, label_image)
    overflow = torch.clamp(big_l + big_r - cap, min=0)
    return objects, label_image, overflow


def _cluster_dynamic(cloud, vel, vnorm, dynamic, *, config, dynamic_speed,
                     depth_diff, cluster_size, neighbor_distance,
                     min_size_cap=None):
    h, w = cloud.points.shape[:2]
    dev = vel.device
    n = h * w
    cap = config.max_objects
    if min_size_cap is None:
        min_size_cap = n
    labels = connected_components(
        dynamic, cloud.points[..., 2], depth_diff,
        neighbor_distance=neighbor_distance, max_iters=config.max_cc_iters,
        stencil_radius=config.neighbor_distance)
    flat_labels = labels.reshape(-1)

    min_size = torch.clamp(cluster_size, 2, min_size_cap).to(torch.int64)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    # Lexicographic order (label asc, ||v|| desc, pixel index asc): the f32
    # bits of non-negative norms are order-isomorphic to the norms, so
    # (label, -bits) packs into one int64 key; a stable sort keeps pixel
    # order among equal keys. Ties decide the median, so this must match
    # the JAX package's three-key lax.sort exactly.
    vbits = vnorm.reshape(-1).contiguous().view(torch.int32).to(torch.int64)
    key = flat_labels.to(torch.int64) * (1 << 32) + ((1 << 31) - vbits)
    order = torch.sort(key, stable=True).indices
    s = flat_labels[order]
    spix = pos[order]
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       s[1:] != s[:-1]])
    # A run starting at i has >= m members iff element i + m - 1 matches.
    s_pad = torch.cat([s, torch.full((n,), n, dtype=torch.int32,
                                     device=dev)])
    tail = s_pad[(pos.to(torch.int64) + min_size - 1)]
    big_start = start & (s < n) & (tail == s)

    # First `cap` big runs in sorted (= ascending root) order.
    cand = torch.where(big_start, pos, torch.full_like(pos, n + 1))
    rpos = torch.topk(cand, min(cap, n), largest=False, sorted=True).values
    if rpos.shape[0] < cap:
        rpos = torch.cat([rpos, rpos.new_full((cap - rpos.shape[0],),
                                              n + 1)])
    roots = torch.where(rpos < n, s[rpos.clamp(max=n - 1).long()],
                        torch.full_like(rpos, n))
    root_valid = roots < n

    # Compact id per pixel and AABB / size per cluster: cap masked passes.
    cid = torch.full((n,), cap, dtype=torch.int32, device=dev)
    for c in range(cap):
        cid = torch.where(root_valid[c] & (flat_labels == roots[c]),
                          torch.tensor(c, dtype=torch.int32, device=dev), cid)
    pts = cloud.points.reshape(n, 3)
    mins, maxs, csize = [], [], []
    inf = float("inf")
    for c in range(cap):
        in_c = (cid == c)[:, None]
        mins.append(torch.where(in_c, pts, inf).amin(dim=0))
        maxs.append(torch.where(in_c, pts, -inf).amax(dim=0))
        csize.append(in_c.sum(dtype=torch.int32))
    mins = torch.stack(mins)
    maxs = torch.stack(maxs)
    csize = torch.stack(csize)

    # Median velocity: the member ranked size//2 by descending norm.
    mpos = torch.clamp(rpos + csize // 2, 0, n - 1).long()
    median_pixel = spix[mpos].long()
    med_vel = vel.reshape(n, 3)[median_pixel]
    med_norm = torch.sqrt((med_vel * med_vel).sum(-1))
    valid = root_valid & (csize > 0) & (med_norm >= dynamic_speed)
    ids = torch.where(valid, torch.cumsum(valid.to(torch.int32), 0) - 1,
                      torch.full_like(csize, -1))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    objects = MovingObjects(
        id=ids.to(torch.int32),
        center=torch.where(valid[:, None], (mins + maxs) * 0.5, zero),
        velocity=torch.where(valid[:, None], med_vel, zero),
        bounding_box=torch.where(valid[:, None], maxs - mins, zero),
        valid=valid)
    label_image = torch.where(cid == cap, torch.full_like(cid, -1),
                              cid).reshape(h, w)
    overflow = torch.clamp(big_start.sum(dtype=torch.int32) - cap, min=0)
    return objects, label_image, overflow, roots
