"""Inputs on which the tiled connected-components kernel, the staged
horizontal and vertical SGM DPs, the tiled census kernel, the v1 SGM
aggregation, cost and WTA kernels and the cluster-stats kernel could go
wrong, shared by the CPU tests against the JAX package
(test_torch_dp_cc_redesign.py, test_torch_vdp_census_redesign.py,
test_torch_v1dp_stats_redesign.py, test_torch_v1cost_wta_redesign.py),
the card tests against the plain versions (test_torch_kernels_gpu.py) and
chip_smoke.py. numpy and torch only: no JAX.
"""

import numpy as np
import torch

from moving_object_detector_tpu_torch.ops import (
    cluster_stats_cuda,
    clustering_cuda,
    sgm,
    sgm_cuda,
    sgm_v1_cuda,
)

TH, TW = clustering_cuda.TILE_H, clustering_cuda.TILE_W
# One shape for every CC case, with partial tiles on both edges, and one
# stencil radius but for one case (so the JAX kernel compiles twice).
CH, CW = 2 * TH + 5, 3 * TW + 7
STENCIL = 4


def _pairs(links):
    """A map of isolated pixel pairs: ``links`` are ((i, j), (v, u))."""
    dyn = np.zeros((CH, CW), bool)
    for a, b in links:
        dyn[a] = dyn[b] = True
    return dyn, np.full((CH, CW), 5.0, np.float32)


def _corner(r):
    # (r, r) across the corner of the first tile; (r, r + 1) is outside
    # the window.
    return _pairs([
        ((TH - 1, TW - 1), (TH - 1 + r, TW - 1 + r)),
        ((TH - 2, 2 * TW - 2), (TH - 2 + r, 2 * TW - 1 + r))])


def _bottom_and_right(r):
    # Exactly r across a bottom edge and across a right edge; r + 1 beside
    # each, no edge.
    return _pairs([
        ((TH - 1, 5), (TH - 1 + r, 5)),
        ((TH - 1, 12), (TH + r, 12)),
        ((3, TW - 1), (3, TW - 1 + r)),
        ((8, TW - 2), (8, TW - 1 + r))])


def _nan_bridge():
    # Two blocks in two tiles whose only link is a row through a dynamic
    # pixel with a NaN depth on the tiles' border: at radius 1 that pixel
    # has no edge and nothing jumps it, so three components.
    dyn = np.zeros((CH, CW), bool)
    dyn[4:10, TW - 6:TW - 1] = True
    dyn[4:10, TW + 2:TW + 8] = True
    dyn[6, TW - 1:TW + 2] = True
    depth = np.where(dyn, 3.0, np.nan).astype(np.float32)
    depth[6, TW] = np.nan
    return dyn, depth


def _partial_tiles():
    rng = np.random.default_rng(11)
    dyn = rng.random((CH, CW)) < 0.35
    depth = (np.round(rng.random((CH, CW)) * 3) + 2.0).astype(np.float32)
    return dyn, depth


def _serpentine():
    h, w = CH, CW
    dyn = np.zeros((h, w), bool)
    dyn[::6, :] = True
    for k, r in enumerate(range(0, h - 6, 6)):
        dyn[r:r + 6, w - 1 if k % 2 == 0 else 0] = True
    return dyn, np.full((h, w), 5.0, np.float32)


# name: (input, radius, stencil radius, components expected or None)
CC_CASES = {
    "corner_offset_r4": (lambda: _corner(4), 4, STENCIL, 3),
    "corner_offset_r2": (lambda: _corner(2), 2, STENCIL, 3),
    "bottom_and_right_edges_r4": (lambda: _bottom_and_right(4), 4, STENCIL,
                                  6),
    "bottom_and_right_edges_r3": (lambda: _bottom_and_right(3), 3, STENCIL,
                                  6),
    "nan_depth_bridge": (_nan_bridge, 1, STENCIL, 3),
    "radius_0": (_partial_tiles, 0, STENCIL, None),
    "radius_above_stencil_clamped": (_partial_tiles, 9, STENCIL, None),
    "partial_tiles_r3": (_partial_tiles, 3, STENCIL, None),
    "serpentine_through_tiles": (_serpentine, 4, STENCIL, 1),
    # Offsets beyond the local phase's reach (4) inside a tile too.
    "radius_6_beyond_local_reach": (_partial_tiles, 6, 6, None),
}


# (h, w, p1, p2): a width below D = 128, widths that are not a multiple of
# 32 (the pad period) or 4 (a lane's window), P1 = P2 = 0, P2 = 127 (the
# int8 limit), P1 > P2.
DP_CASES = [(6, 37, 10, 120), (5, 171, 10, 120), (4, 150, 0, 0),
            (4, 133, 10, 127), (4, 150, 40, 7)]


# The vertical DP stages V_ROWS-row blocks of a strip of columns sized to
# the card (sgm_cuda.v_strip; an H100 has 132 SMs). (h, w, p1, p2):
# heights 1, below, equal to and not a multiple of the row block; widths
# below D = 128 and whose last strip is partial on an H100 (133: strip 3;
# 1000: strip 16; 4500: the widest strip, 32, and more blocks than SMs);
# the four penalty pairs of DP_CASES and a P1 above the 160 at which the
# kernel clamps it (the same paths for every P1 >= 160).
VR = sgm_cuda.V_ROWS
H100_SMS = 132
VDP_CASES = [(1, 133, 10, 120), (VR - 3, 37, 10, 120), (VR, 133, 0, 0),
             (2 * VR + 5, 133, 10, 127), (2 * VR + 5, 37, 40, 7),
             (VR + 1, 1000, 10, 120), (3, 4500, 40, 7), (1, 37, 40, 7),
             (VR - 1, 133, 500, 127)]

# The census kernel stages CENSUS_TILE_H x CENSUS_TILE_W tiles with the
# window's halo. name: (h, w, window, kind); kind "random", "constant"
# (every neighbour ties) or "nonfinite" (NaN, +inf, -inf and signed zeros
# among the pixels).
CTH, CTW = sgm_v1_cuda.CENSUS_TILE_H, sgm_v1_cuda.CENSUS_TILE_W
CENSUS_CASES = {
    "1x1": (1, 1, (5, 5), "random"),
    "2x3": (2, 3, (5, 5), "random"),
    "smaller_than_the_halo_3x9": (2, 5, (3, 9), "random"),
    "not_a_multiple_of_the_tile": (2 * CTH + 3, CTW + 5, (5, 5), "random"),
    "three_tiles_down_two_across": (3 * CTH, 2 * CTW + 7, (5, 5), "random"),
    "constant_ties": (CTH + 3, 40, (5, 5), "constant"),
    "nan_and_inf_pixels": (CTH + 5, CTW + 22, (5, 5), "nonfinite"),
    "window_3x3": (CTH + 1, CTW + 12, (3, 3), "random"),
    "window_3x9": (CTH + 2, CTW + 3, (3, 9), "random"),
    "window_11x3_nonfinite": (2 * CTH + 1, 50, (11, 3), "nonfinite"),
    "window_1x33": (3, 70, (1, 33), "random"),
}


def census_pair(case):
    """(left, right) f32 images of a census case, from a seed."""
    h, w, _, kind = CENSUS_CASES[case]
    rng = np.random.default_rng(h * 1000 + w)
    if kind == "constant":
        flat = np.full((h, w), 0.25, np.float32)
        return flat, flat.copy()
    # Few grey levels: many neighbours tie with their centre.
    left, right = (np.round(rng.uniform(0, 1, (2, h, w)) * 8) / 8).astype(
        np.float32)
    if kind == "nonfinite":
        for img in (left, right):
            u = rng.random((h, w))
            img[u < 0.06] = np.nan
            img[(u >= 0.06) & (u < 0.12)] = np.inf
            img[(u >= 0.12) & (u < 0.18)] = -np.inf
            img[(u >= 0.18) & (u < 0.22)] = -0.0
            img[(u >= 0.22) & (u < 0.26)] = 0.0
    return left, right


# The v1 aggregation walks each line both ways in steps copied
# AGG_ROW_STEPS (along a row) or AGG_COL_STEPS (down a column) at a time
# into a ring of AGG_RING_BUFS chunks, the two walks meeting in the
# middle; it keeps byte deltas in shared memory up to AGG_SMEM_WIDTH /
# AGG_SMEM_HEIGHT and P2 <= AGG_DELTA8_MAX_P2, and reads and rewrites the
# total in global memory beyond. (h, w, p1, p2, kind); kind "hamming"
# (costs 0 .. 32, as the cost kernel gives them) or "int8" (any int8,
# negative ones clipped to 0 on read). Lengths 1, 2, odd, at and around a
# chunk and the ring (a walk's half of the line); widths and heights on
# both sides of the shared-memory limits (lines of a few pixels across);
# the (P1, P2) pairs of the serving point, P1 = P2 = 0, P2 > 255, P1 > P2
# (clamped to P2 in the kernel) and the int16 limit, and P2 on both sides
# of the byte deltas' limit.
RS, CS = sgm_v1_cuda.AGG_ROW_STEPS, sgm_v1_cuda.AGG_COL_STEPS
AB = sgm_v1_cuda.AGG_RING_BUFS
AGG_WIDE, AGG_TALL = sgm_v1_cuda.AGG_SMEM_WIDTH, sgm_v1_cuda.AGG_SMEM_HEIGHT
P2_BYTE = sgm_v1_cuda.AGG_DELTA8_MAX_P2
AGG_PENALTIES = ((10, 120), (0, 0), (3, 500), (200, 120), (10, 8063))
AGG_CASES = [
    (1, 1, 10, 120, "int8"),
    (2, 2, 0, 0, "int8"),
    (1, 2 * RS + 1, 10, 8063, "hamming"),
    (CS, RS, 200, 120, "int8"),
    (CS + 1, 2 * RS * AB - 1, 3, 500, "int8"),
    (2 * CS * AB - 1, RS + 1, 10, 120, "hamming"),
    (2 * CS * AB + 1, 2 * RS * AB, 10, 120, "int8"),
    (4 * CS * AB + 3, 37, 10, 8063, "int8"),
    (5, 33, 10, P2_BYTE, "int8"),
    (5, 33, 10, P2_BYTE + 1, "int8"),
    (2, AGG_WIDE, 10, 120, "hamming"),
    (2, AGG_WIDE + 1, 10, 120, "hamming"),
    (AGG_TALL, 2, 10, 120, "hamming"),
    (AGG_TALL + 1, 2, 10, 120, "hamming"),
]
# Small enough for the JAX package's Pallas kernel in interpret mode.
AGG_PALLAS_CASES = [c for c in AGG_CASES if c[0] * c[1] <= 40 * 40]
# The serving shape (SGM at half of 376 x 1242) and the full frame, whose
# column launch takes fewer columns a block than the card's strip.
AGG_SERVING = (188, 621)
AGG_FULL = (376, 1242)


def agg_cost(h, w, kind, seed=0):
    """An (h, w, 128) int8 cost volume of an aggregation case."""
    rng = np.random.default_rng(seed + h * 7919 + w)
    if kind == "hamming":
        return rng.integers(0, 33, (h, w, 128)).astype(np.int8)
    return rng.integers(-128, 128, (h, w, 128)).astype(np.int8)


# The v1 cost kernel takes COST_TX adjacent pixels of a row a block and
# compares each with the 128 right pixels x - d, x - d < 0 costing 32.
# name: (h, w, census window, kind); kind "shifted" (the right view the
# left one shifted by 9 px, with noise) or "complement" (the right view
# the negated left one shifted by 5 px: with a 1 x 33 window, 32
# neighbours, every pixel whose window lies inside the image costs
# popcount 32 at d = 5, beside the 32 of x < d). Widths 1, below D,
# around a block (COST_TX - 1, COST_TX, COST_TX + 1) and over two blocks
# past D; a height of 1.
TX = sgm_v1_cuda.COST_TX
COST_CASES = {
    "width_1": (3, 1, (5, 5), "shifted"),
    "height_1": (1, 150, (5, 5), "shifted"),
    "width_37_below_d": (5, 37, (5, 5), "shifted"),
    "width_tx_minus_1": (4, TX - 1, (5, 5), "shifted"),
    "width_tx": (4, TX, (5, 5), "shifted"),
    "width_tx_plus_1": (4, TX + 1, (5, 5), "shifted"),
    "three_blocks_past_d": (6, 2 * TX + 29, (5, 5), "shifted"),
    "all_32_bits_differ": (3, 140, (1, 33), "complement"),
}


def cost_pair(case):
    """(left, right) f32 images of a cost case, from a seed."""
    h, w, _, kind = COST_CASES[case]
    rng = np.random.default_rng(h * 1000 + w)
    left = rng.uniform(0, 1, (h, w)).astype(np.float32)
    if kind == "complement":
        return left, -np.roll(left, -5, axis=1)
    right = np.roll(left, -9, axis=1) + rng.normal(0, 0.02, (h, w))
    return left, right.astype(np.float32)


# The v1 WTA takes four pixels a warp, eight lanes a pixel, and packs
# total * 128 + d (the lowest d wins a tie); its subpixel neighbours come
# from the lane that holds best -+ 1, its right view from atomics into a
# padded row. name: (h, w, kind), an (h, w, 128) int16 total each:
# - "ties": totals 0..2, ties over d everywhere;
# - "best_at_0_1_126_127": the minimum at d = 0, 1, 126, 127 in turn;
# - "right_flat": total(best + 1) = total(best), so the offset is exactly
#   +0.5 and x - disp lies at .5 (rint rounds half to even; the lowest-d
#   tie rule keeps total(best - 1) above the minimum, so the parabola's
#   denominator is >= 1 and never at or below 1e-6);
# - "x_below_best": minima at d >= 100, so x < best over most of the row;
# - "negative": totals in [-2000, 0);
# - "int16_extremes": -32768, -32767, 32766, 32767 beside random values
#   (at a width of 128, where the Pallas kernel pads no column: its pad
#   total of 20000 would beat larger right-view candidates);
# - "right_view_ties": total(x, d) a function of x - d, so that every
#   right pixel's candidates tie (noise breaks some ties);
# - "aggregated_pair": the plain aggregation of a shifted random pair.
WTA_V1_CASES = {
    "ties": (8, 150, "ties"),
    "best_at_0_1_126_127": (8, 150, "edges"),
    "right_flat": (8, 150, "right_flat"),
    "x_below_best": (8, 150, "far"),
    "negative": (8, 150, "negative"),
    "int16_extremes": (8, 128, "extremes"),
    "right_view_ties": (8, 150, "right_ties"),
    "aggregated_pair": (8, 150, "aggregated"),
}
# (subpixel, lr_check, lr_max_diff)
WTA_V1_FLAGS = [(sub, lr, md) for sub in (True, False) for lr in (True, False)
                for md in (0.0, 1.0)]


def wta_total(case):
    """The (h, w, 128) int16 total of a WTA case, from a seed."""
    h, w, kind = WTA_V1_CASES[case]
    rng = np.random.default_rng(h * 1000 + w + len(kind))
    d = np.arange(128)
    if kind == "ties":
        return rng.integers(0, 3, (h, w, 128)).astype(np.int16)
    if kind == "negative":
        return rng.integers(-2000, 0, (h, w, 128)).astype(np.int16)
    if kind == "extremes":
        tot = rng.integers(-32768, 32768, (h, w, 128))
        pick = rng.random((h, w, 128))
        for k, v in enumerate((-32768, -32767, 32766, 32767)):
            tot[(pick >= 0.1 * k) & (pick < 0.1 * (k + 1))] = v
        tot[:, 1::5] = 32767  # every candidate at the top
        return tot.astype(np.int16)
    if kind == "right_ties":
        x = np.arange(w)[:, None]
        tot = np.broadcast_to(((x - d) % 7) * 10 + 100, (h, w, 128)).copy()
        noise = rng.random((h, w, 128)) < 0.03
        tot[noise] = rng.integers(80, 160, int(noise.sum()))
        return tot.astype(np.int16)
    if kind == "aggregated":
        left = rng.uniform(0, 1, (h, w)).astype(np.float32)
        right = (np.roll(left, -7, axis=1)
                 + rng.normal(0, 0.02, (h, w))).astype(np.float32)
        cl = sgm.census_transform(torch.from_numpy(left))
        cr = sgm.census_transform(torch.from_numpy(right))
        return sgm.aggregate_cost_volume(sgm.hamming_cost(cl, cr, 128), 10,
                                         120).numpy()
    tot = rng.integers(200, 400, (h, w, 128))
    best = {"edges": np.array([0, 1, 126, 127])[np.arange(w) % 4],
            "right_flat": rng.integers(1, 127, w),
            "far": rng.integers(100, 128, w)}[kind]
    cols = np.arange(w)
    tot[:, cols, best] = 50
    if kind == "right_flat":
        tot[:, cols, best + 1] = 50
        tot[:, cols, best - 1] = 50 + rng.integers(1, 30, (h, w))
    return tot.astype(np.int16)


# The cluster-stats kernel takes 32 adjacent pixels of a row a warp,
# STATS_THREADS a block, and up to MAX_CAP slots. name: (h, w, cap, kind).
STATS_THREADS = cluster_stats_cuda.STATS_THREADS
CAP = cluster_stats_cuda.MAX_CAP
STATS_CASES = {
    "cap_1": (9, 70, 1, "components"),
    "cap_32": (23, 97, CAP, "components"),
    "repeated_roots": (17, 45, 8, "repeated"),
    "all_slots_unused": (12, 40, 6, "unused"),
    "one_cluster_over_the_image": (31, 83, 4, "whole"),
    "signed_zeros_and_nan_members": (14, 66, 8, "zeros_nan"),
    "strided_crop_of_points": (21, 57, 16, "crop"),
    # h * w = 7 * 45 = 315: not a multiple of the block, 45 not of a warp.
    "not_a_multiple_of_the_block": (7, 45, 5, "components"),
}


def stats_case(name):
    """(labels (h, w) int32, points (h, w, 3) f32, roots (cap,) int32) of
    a stats case, from a seed. Labels are CC-style (a component's label
    is a member's flat index, h * w the background); points outside the
    selected clusters are NaN; "crop" gives points as a strided view into
    a larger frame."""
    h, w, cap, kind = STATS_CASES[name]
    n = h * w
    rng = np.random.default_rng(h * 131 + w)
    if kind == "whole":
        labels = np.zeros((h, w), np.int32)
        comp = np.array([0], np.int32)
    else:
        n_comp = max(cap + 3, 6)
        comp = np.sort(rng.choice(n, n_comp, replace=False)).astype(np.int32)
        flat = np.full((n,), n, np.int32)
        assign = rng.integers(0, n_comp + 1, n)  # n_comp: background
        for i, r in enumerate(comp):
            flat[assign == i] = r
            flat[r] = r
        labels = flat.reshape(h, w)
    roots = np.full((cap,), n, np.int32)
    k = 0 if kind == "unused" else min(cap, comp.size)
    roots[:k] = comp[:k]
    if kind == "repeated":  # slots 0 / 3 and 1 / 6 repeat; 7 unused
        roots[3], roots[6], roots[7] = roots[0], roots[1], n
    big = rng.normal(0, 4, (h + 6, w + 9, 3)).astype(np.float32)
    points = big[2:2 + h, 5:5 + w] if kind == "crop" else big[:h, :w].copy()
    member = np.isin(labels, roots[roots < n])
    points[~member] = np.nan
    if kind == "zeros_nan":
        # x >= 0 and y <= 0 with +0.0 and -0.0 among them: every slot's
        # min x and max y is a zero of either sign.
        u = rng.random((h, w))
        points[..., 0] = np.abs(points[..., 0])
        points[..., 1] = -np.abs(points[..., 1])
        points[member & (u < 0.3), 0] = 0.0
        points[member & (u >= 0.7), 0] = -0.0
        points[member & (u < 0.2), 1] = -0.0
        points[member & (u >= 0.6), 1] = 0.0
        ys, xs = np.nonzero(labels == roots[2])
        points[ys[0], xs[0], 2] = np.nan  # slot 2's z: NaN
    return labels, points, roots


def on_device(points, device):
    """``points`` on ``device`` with its strides: a view into a copy of
    its base array where it is one (the strided crop)."""
    if points.base is None or points.flags.c_contiguous:
        return torch.from_numpy(np.ascontiguousarray(points)).to(device)
    base = torch.from_numpy(points.base).to(device)
    offset = (points.__array_interface__["data"][0]
              - points.base.__array_interface__["data"][0])
    return base.as_strided(points.shape, [s // 4 for s in points.strides],
                           offset // 4)
