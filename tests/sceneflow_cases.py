"""Inputs on which the fused scene-flow kernel (four pixels of the flat
index a thread, 16-byte accesses, a scalar tail) could go wrong, shared by
the CPU test against the JAX package's Pallas kernel in interpret mode
(test_torch_sceneflow_fused.py), the card tests against the plain version
(test_torch_kernels_gpu.py) and chip_smoke.py: widths with every residue
mod 4, odd pixel counts, images of one to a few pixels, matches on both
sides of the covered window's edges, and NaN and +-inf flow. numpy only.
"""

import numpy as np

# name: (H, W, v_radius, h_radius, what the flow does)
FUSED_CASES = {
    "w_mod4_0": (6, 128, 16, 128, "random"),
    "w_mod4_1": (6, 129, 16, 128, "random"),
    "w_mod4_2": (6, 130, 16, 128, "random"),
    "w_mod4_3": (6, 131, 16, 128, "random"),
    "odd_pixels": (7, 133, 16, 128, "random"),
    "one_pixel": (1, 1, 16, 128, "random"),
    "one_row": (1, 5, 16, 128, "random"),
    "three_by_seven": (3, 7, 16, 128, "random"),
    "window_edges": (40, 301, 8, 128, "window_edges"),
    "nan_inf_flow": (9, 37, 16, 128, "nan_inf"),
}


def params(h: int, w: int) -> np.ndarray:
    """The (27,) f32 parameter vector (layout of ops/sceneflow_cuda.py):
    a camera off the image centre, disparity range [0.5, 127], a
    non-identity transform, dt 0.1, a dynamic threshold of 5 px and a
    disparity-rate test of 30."""
    return np.array(
        [721.5, 720.0, w / 2 - 3, h / 2 + 2, 721.5, 0.54, 0.5, 127.0,
         721.5, 0.54, 0.5, 127.0,
         0.99999, -0.001, 0.004, 0.05, 0.001, 0.99999, -0.002, -0.02,
         -0.004, 0.002, 0.99999, 0.3, 0.1, 5.0, 30.0], np.float32)


def _window_edge_flow(h, w, rg, rt, rng):
    """Flow that sends each pixel to a row or column on the edge of its
    covered window (8-row groups within rg, 128-column tiles within rt)
    or one past it, in integers, so the rounding cannot move it."""
    flow = np.zeros((h, w, 2), np.float32)
    for i in range(h):
        for j in range(w):
            g, t = i >> 3, j >> 7
            rows = (8 * (g - rg), 8 * (g - rg) - 1, 8 * (g + rg + 1) - 1,
                    8 * (g + rg + 1))
            cols = (128 * (t - rt), 128 * (t - rt) - 1,
                    128 * (t + rt + 1) - 1, 128 * (t + rt + 1))
            k = rng.integers(0, 3)
            vp = rows[rng.integers(0, 4)] if k != 1 else i
            up = cols[rng.integers(0, 4)] if k != 0 else j
            flow[i, j] = (j - up, i - vp)
    return flow


def fused_case(name: str):
    """(d_now, d_prev, flow, params, v_radius, h_radius) of a case:
    disparities with invalid (-1), NaN and zero pixels."""
    h, w, vr, hr, kind = FUSED_CASES[name]
    rng = np.random.default_rng(sorted(FUSED_CASES).index(name))
    d_now = rng.uniform(1, 100, (h, w)).astype(np.float32)
    d_prev = rng.uniform(1, 100, (h, w)).astype(np.float32)
    d_now[rng.random((h, w)) < 0.1] = -1.0
    d_prev[rng.random((h, w)) < 0.1] = np.nan
    d_prev[rng.random((h, w)) < 0.05] = 0.0
    if kind == "window_edges":
        flow = _window_edge_flow(h, w, -(-vr // 8), -(-hr // 128), rng)
    else:
        flow = rng.normal(0, 8, (h, w, 2)).astype(np.float32)
        flow[rng.random((h, w)) < 0.1] += 0.5  # halves: round to even
    if kind == "nan_inf":
        specials = np.array([np.nan, np.inf, -np.inf], np.float32)
        for c in range(2):
            hit = rng.random((h, w)) < 0.15
            flow[hit, c] = rng.choice(specials, int(hit.sum()))
    return d_now, d_prev, flow, params(h, w), vr, hr
