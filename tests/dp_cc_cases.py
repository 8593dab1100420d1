"""Inputs on which the tiled connected-components kernel, the staged
horizontal and vertical SGM DPs and the tiled census kernel could go
wrong, shared by the CPU tests against the JAX package
(test_torch_dp_cc_redesign.py, test_torch_vdp_census_redesign.py), the
card tests against the plain versions (test_torch_kernels_gpu.py) and
chip_smoke.py. numpy only: no JAX.
"""

import numpy as np

from moving_object_detector_tpu_torch.ops import (
    clustering_cuda,
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
