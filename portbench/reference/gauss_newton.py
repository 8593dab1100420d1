"""Frozen copy of
``moving_object_detector_tpu_torch/ops/gauss_newton_cuda.py`` (its plain
versions) at fc97bde, the benchmark's plain reference: it imports
nothing of the port.

Ego-motion's Gauss-Newton pose solves and its RANSAC, plain PyTorch.

``solve_pose_plain``: ``iters`` damped Gauss-Newton updates of the
left-increment twist from the identity, for B problems at once.
``ransac_solve_plain``: the whole RANSAC from given hypothesis indices,
the hypotheses' solves, their MSAC scores and inliers, the stable top-k,
the two-pass refinement of each candidate and the pick of the best.
"""

from __future__ import annotations

import torch

from . import geometry


def camera_vector(cam) -> torch.Tensor:
    """(fx, fy, cx, cy) of a ``CameraModel`` as one (4,) f32 tensor on the
    camera's device (no fetch)."""
    return torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]).to(torch.float32)


def transform(tf, pts):
    """(..., 4, 4) transforms applied to (..., N, 3) points."""
    return pts @ tf[..., :3, :3].transpose(-1, -2) + tf[..., None, :3, 3]


def reprojection_residuals(tf, pts3d, obs_uv, fx, fy, cx, cy):
    """(..., N, 2) residuals pi(M X) - x, the moved points and the
    positive-depth mask."""
    p = transform(tf, pts3d)
    z = p[..., 2]
    ok = z > 0.1
    safe_z = torch.where(ok, z, torch.ones_like(z))
    u = fx * p[..., 0] / safe_z + cx
    v = fy * p[..., 1] / safe_z + cy
    return torch.stack([u, v], dim=-1) - obs_uv, p, ok


def msac_score(err, valid, threshold: float):
    """Truncated squared reprojection error summed over the last axis, the
    full square of ``threshold`` where not ``valid``."""
    th2 = threshold ** 2
    return torch.where(valid, torch.clamp(err ** 2, max=th2),
                       torch.full_like(err, th2)).sum(-1)


def chol_solve6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for damped-SPD (..., 6, 6) systems, unrolled
    Cholesky (the JAX package's form, batched over leading dims)."""
    n = 6
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        s = a[..., i, i]
        for k in range(i):
            s = s - l[i][k] * l[i][k]
        l[i][i] = torch.sqrt(torch.clamp(s, min=1e-20))
        for j in range(i + 1, n):
            s = a[..., j, i]
            for k in range(i):
                s = s - l[j][k] * l[i][k]
            l[j][i] = s / l[i][i]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def gn_step(tf, pts3d, obs_uv, weights, cam, damping=1e-4):
    """One damped Gauss-Newton update on the left-increment twist, batched
    over leading dims of ``tf`` (..., 4, 4) / ``weights`` (..., N);
    ``cam`` is the (4,) vector of ``camera_vector``."""
    fx, fy, cx, cy = cam.unbind()
    res, p, ok = reprojection_residuals(tf, pts3d, obs_uv, fx, fy, cx, cy)
    w = weights * ok
    z = torch.where(ok, p[..., 2], torch.ones_like(p[..., 2]))
    x, y = p[..., 0], p[..., 1]
    inv_z = 1.0 / z
    zeros = torch.zeros_like(z)
    ones = torch.ones_like(z)
    du_dp = torch.stack([fx * inv_z, zeros, -fx * x * inv_z * inv_z], -1)
    dv_dp = torch.stack([zeros, fy * inv_z, -fy * y * inv_z * inv_z], -1)
    dp_dxi = torch.stack([
        torch.stack([zeros, p[..., 2], -p[..., 1], ones, zeros, zeros], -1),
        torch.stack([-p[..., 2], zeros, p[..., 0], zeros, ones, zeros], -1),
        torch.stack([p[..., 1], -p[..., 0], zeros, zeros, zeros, ones], -1),
    ], dim=-2)  # (..., N, 3, 6)
    j_u = torch.einsum("...ni,...nij->...nj", du_dp, dp_dxi)
    j_v = torch.einsum("...ni,...nij->...nj", dv_dp, dp_dxi)
    jac = torch.stack([j_u, j_v], dim=-2)  # (..., N, 2, 6)
    jw = jac * w[..., None, None]
    jtj = torch.einsum("...nri,...nrj->...ij", jw, jac)
    jtr = torch.einsum("...nri,...nr->...i", jw, res)
    jtj = jtj + damping * torch.eye(6, dtype=torch.float32,
                                    device=tf.device)
    xi = -chol_solve6(jtj, jtr)
    return geometry.se3_exp(xi) @ tf


def solve_pose_plain(pts3d, obs_uv, weights, cam, iters: int,
                     damping: float = 1e-4):
    """Plain version: Gauss-Newton from the identity; the batch is the
    leading dims of ``weights``."""
    tf = torch.eye(4, dtype=torch.float32, device=weights.device).expand(
        weights.shape[:-1] + (4, 4)).contiguous()
    for _ in range(iters):
        tf = gn_step(tf, pts3d, obs_uv, weights, cam, damping)
    return tf


def ransac_candidates(cfg, hypotheses: int) -> int:
    """The refinement candidates of a RANSAC over ``hypotheses``:
    ``refine_candidates`` clamped to [1, ransac_hypotheses], and to the
    hypotheses there are."""
    return min(max(1, min(cfg.refine_candidates, cfg.ransac_hypotheses)),
               hypotheses)


def ransac_solve_plain(pts3d, tracked, feat_valid, cam, sample_idx, cfg):
    """Plain version of ``ransac_solve``: the hypotheses' solves, their
    scores and inliers, the stable top-k, two refinements of each
    candidate, the best by final score."""
    fx, fy, cx, cy = cam.unbind()

    def residuals(tf):
        res, _, ok = reprojection_residuals(tf, pts3d, tracked, fx, fy, cx, cy)
        return torch.linalg.vector_norm(res, dim=-1), feat_valid & ok

    th = cfg.inlier_threshold_px
    ones = torch.ones(sample_idx.shape, dtype=torch.float32,
                      device=pts3d.device)
    tfs = solve_pose_plain(pts3d[sample_idx], tracked[sample_idx], ones, cam,
                           cfg.gn_iters_hypothesis)
    err, used = residuals(tfs)
    inliers = used & (err < th)
    scores = msac_score(err, used, th)

    top_idx = torch.sort(scores, stable=True).indices[
        :ransac_candidates(cfg, scores.shape[0])]

    tf = solve_pose_plain(pts3d, tracked, inliers[top_idx].float(), cam,
                          cfg.gn_iters_refine)
    err, used = residuals(tf)
    tight = used & (err < 0.5 * th)
    tf = solve_pose_plain(pts3d, tracked, tight.float(), cam,
                          cfg.gn_iters_refine)
    err, used = residuals(tf)
    counts = (used & (err < th)).sum(-1).to(torch.int32)
    best = torch.argmin(msac_score(err, used, th))
    count = counts[best]
    success = count >= cfg.min_inliers
    eye = torch.eye(4, dtype=torch.float32, device=pts3d.device)
    return torch.where(success, tf[best], eye), success, count
