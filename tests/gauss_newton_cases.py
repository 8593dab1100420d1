"""Inputs of ego-motion's Gauss-Newton pose solve and its RANSAC, shared
by the CPU tests against the JAX package (test_torch_gauss_newton.py,
test_torch_ransac_gn.py), the card tests against the plain versions
(test_torch_kernels_gpu.py) and chip_smoke.py: correspondences of a known
camera motion, the two shapes the RANSAC gives the solve, the RANSAC's
cases, and the rule that tells an ill-conditioned 3-point hypothesis from
a sound one. numpy only: no JAX, no torch.
"""

import numpy as np

CAM = (721.5, 721.5, 621.0, 188.0)  # fx, fy, cx, cy (KITTI-like)
ROTVEC = (0.002, -0.01, 0.003)  # the camera's rotation, axis * angle
TRANS = (0.05, -0.01, 0.6)  # and translation, m
# (problems, points, iterations): the RANSAC hypotheses (3 points each,
# EgoMotionConfig's 64 x 5), its refinement (4 candidates over the 512
# shared features, 8 iterations) and an odd size.
SHAPES = {"hypothesis": (64, 3, 5), "refine": (4, 512, 8),
          "odd": (5, 37, 6)}
# A 3-point hypothesis counts as sound (``sound``) when the plain solve
# converged to an exact fit (every residual below RES_LIMIT px) with its
# points in front of the camera, and the damped normal matrix there has a
# 2-norm condition number below COND_LIMIT (float64). On the synthetic
# correspondences about 45 % of random triples pass, and perturbing their
# inputs by an ulp moves their poses by at most 3e-5; among the others,
# triples that did not converge or sit above a condition number of 1e6
# move by up to 1.
COND_LIMIT = 1e5
RES_LIMIT = 0.01
# The RANSAC's cases, (features N, hypotheses H, refine_candidates K):
# the serving shape (EgoMotionConfig's 512 features, 64 hypotheses, 4
# candidates), one and more candidates than a thread-block cluster holds
# (16), and odd N and H.
RANSAC_CASES = {"serving": (512, 64, 4), "serving_k1": (512, 64, 1),
                "serving_k16": (512, 64, 16), "odd": (37, 50, 4),
                "odd_k1": (37, 50, 1), "odd_k16": (37, 50, 16)}


def rotation(rotvec=ROTVEC) -> np.ndarray:
    """Rodrigues' formula in float64."""
    w = np.asarray(rotvec, np.float64)
    theta = np.linalg.norm(w)
    k = w / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def correspondences(n: int, seed: int = 0, outliers: float = 0.08):
    """(pts3d (n, 3), uv (n, 2)) f32: points 4 to 40 m ahead seen after
    the known motion, with 0.3 px of noise and a share of outliers moved
    by 20 px."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 40, n)], 1).astype(np.float32)
    moved = pts.astype(np.float64) @ rotation().T + np.asarray(TRANS)
    fx, fy, cx, cy = CAM
    uv = np.stack([fx * moved[:, 0] / moved[:, 2] + cx,
                   fy * moved[:, 1] / moved[:, 2] + cy], 1)
    uv += rng.normal(0, 0.3, uv.shape)
    uv[:int(outliers * n)] += 20.0
    return pts, uv.astype(np.float32)


def problem(shape: str, seed: int = 0):
    """(pts3d, uv, weights, iters) of one shape: the hypotheses gather
    their 3 points per problem ((B, 3, 3), (B, 3, 2), weights of one);
    the others share the points and weight them 0 or 1 per problem."""
    b, n, iters = SHAPES[shape]
    rng = np.random.default_rng(seed + 1)
    if shape == "hypothesis":
        pts, uv = correspondences(512, seed)
        idx = np.stack([rng.choice(512, n, replace=False) for _ in range(b)])
        return pts[idx], uv[idx], np.ones((b, n), np.float32), iters
    pts, uv = correspondences(n, seed)
    weights = (rng.random((b, n)) < 0.8).astype(np.float32)
    return pts, uv, weights, iters


def ransac_case(name: str, seed: int = 0):
    """(pts3d, uv, valid, idx) of a RANSAC case: correspondences with 8 %
    outliers, every tenth feature (from the fourth) invalid, and H rows of
    3 distinct valid features."""
    n, h, _ = RANSAC_CASES[name]
    pts, uv = correspondences(n, seed)
    valid = np.ones(n, bool)
    valid[3::10] = False
    rng = np.random.default_rng(seed + 7)
    idx = np.stack([rng.choice(np.flatnonzero(valid), 3, replace=False)
                    for _ in range(h)])
    return pts, uv, valid, idx


def sound(tfs, pts3d, uv, weights, damping: float = 1e-4, cam=CAM):
    """(B,) bool: the hypotheses a comparison can hold to a tolerance.
    At the pose the plain solve reached, every weighted point lies in
    front of the camera (z > 0.1: a point that crosses that plane drops
    out of the sums, and the solve with it), fits its observation within
    RES_LIMIT px (the solve converged: a triple that diverges or still
    moves after its iterations goes where the rounding sends it), and the
    damped normal matrix J^T W J + damping I has a condition number below
    COND_LIMIT. ``cam`` is (fx, fy, cx, cy)."""
    fx, fy, cx, cy = cam
    tfs = np.asarray(tfs, np.float64)
    out = np.zeros(tfs.shape[0], bool)
    for b, tf in enumerate(tfs):
        x = np.asarray(pts3d if pts3d.ndim == 2 else pts3d[b], np.float64)
        o = np.asarray(uv if uv.ndim == 2 else uv[b], np.float64)
        used = weights[b] != 0
        if not np.isfinite(tf).all():
            continue
        p = x @ tf[:3, :3].T + tf[:3, 3]
        if (p[used, 2] <= 0.1).any():
            continue
        res = np.stack([fx * p[:, 0] / p[:, 2] + cx,
                        fy * p[:, 1] / p[:, 2] + cy], 1) - o
        if not (np.abs(res[used]) < RES_LIMIT).all():
            continue
        a = damping * np.eye(6)
        for (px, py, pz), w in zip(p, weights[b]):
            du = np.array([fx / pz, 0, -fx * px / pz ** 2])
            dv = np.array([0, fy / pz, -fy * py / pz ** 2])
            d = np.array([[0, pz, -py, 1, 0, 0], [-pz, 0, px, 0, 1, 0],
                          [py, -px, 0, 0, 0, 1]])
            j = np.stack([du @ d, dv @ d])
            a += w * j.T @ j
        out[b] = np.linalg.cond(a) < COND_LIMIT
    return out
