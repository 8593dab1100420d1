"""Inputs on which the tiled connected-components kernel and the staged
horizontal SGM DP could go wrong, shared by the CPU tests against the JAX
package (test_torch_dp_cc_redesign.py) and the card tests against the
plain versions (test_torch_kernels_gpu.py). numpy only: no JAX.
"""

import numpy as np

from moving_object_detector_tpu_torch.ops import clustering_cuda

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
