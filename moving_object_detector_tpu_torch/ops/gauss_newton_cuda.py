"""Ego-motion's batched Gauss-Newton pose solve: wrapper of
``csrc/gauss_newton.cu`` and its plain version.

``iters`` damped Gauss-Newton updates of the left-increment twist from
the identity, for B problems at once: the reprojection residuals of the
moved points, the weighted normal equations, a 6 x 6 Cholesky solve and
the SE(3) exponential left-multiplied onto the transform. The reference
package compiles this as one ``fori_loop`` inside its compiled
``estimate_motion`` (``egomotion.py:_solve_pose``); eagerly, the plain
version dispatches some 250 small operations an iteration.

For CUDA tensors ``solve_pose`` launches the kernel, which runs all
iterations of all problems in one launch, and adds one to
``LAUNCHES["gauss_newton"]``; for CPU tensors it runs the plain version
``solve_pose_plain``, whose arithmetic the kernel repeats in the same
order. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import geometry

LAUNCHES = {"gauss_newton": 0}
THREADS = (32, 64, 128, 256)  # block sizes the kernel takes
_typed = False


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


def default_threads(n: int) -> int:
    """Threads a block for N points: one warp up to 32 points, else 128."""
    return 32 if n <= 32 else 128


def _check(pts3d, obs_uv, weights, cam, iters, threads):
    """Raise on what the kernel does not take; returns (B, N)."""
    tensors = (pts3d, obs_uv, weights, cam)
    if any(x.device != weights.device for x in tensors):
        raise ValueError("Gauss-Newton inputs must be on one device")
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("the Gauss-Newton solve takes f32 inputs")
    if weights.dim() != 2 or weights.shape[0] < 1:
        raise ValueError(f"weights must be (B, N) with B >= 1, not "
                         f"{tuple(weights.shape)}")
    b, n = weights.shape
    for x, c, name in ((pts3d, 3, "pts3d"), (obs_uv, 2, "obs_uv")):
        if tuple(x.shape) not in ((n, c), (b, n, c)):
            raise ValueError(f"{name} must be ({n}, {c}) or ({b}, {n}, {c}),"
                             f" not {tuple(x.shape)}")
    if tuple(cam.shape) != (4,):
        raise ValueError("cam must be the (4,) vector (fx, fy, cx, cy)")
    if iters < 0:
        raise ValueError("iters must not be negative")
    if threads not in THREADS:
        raise ValueError(f"threads must be one of {THREADS}")
    return b, n


def _lib():
    global _typed
    lib = _build.load("gauss_newton")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gauss_newton.argtypes = [P, I, P, I, P, P, P, I, I, I,
                                     ctypes.c_float, I, P]
        lib.gauss_newton.restype = I
        _typed = True
    return lib


def solve_pose(pts3d, obs_uv, weights, cam, iters: int,
               damping: float = 1e-4, threads: int | None = None):
    """(B, 4, 4) poses: ``iters`` damped Gauss-Newton updates from the
    identity of B problems, each weighting N correspondences by its row of
    ``weights`` (B, N). ``pts3d`` (N, 3) / ``obs_uv`` (N, 2) are shared by
    all problems, or given per problem as (B, N, 3) / (B, N, 2); ``cam``
    is the (4,) vector of ``camera_vector``. One kernel launch for CUDA
    tensors, the plain version for CPU tensors."""
    if threads is None:
        threads = default_threads(weights.shape[-1])
    b, n = _check(pts3d, obs_uv, weights, cam, iters, threads)
    if weights.device.type == "cpu":
        return solve_pose_plain(pts3d, obs_uv, weights, cam, iters, damping)
    if weights.device.type != "cuda":
        raise ValueError("the Gauss-Newton kernel takes CUDA tensors")
    pts3d, obs_uv, weights, cam = (x.contiguous() for x in
                                   (pts3d, obs_uv, weights, cam))
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=weights.device)
    rc = _lib().gauss_newton(
        pts3d.data_ptr(), 3 * n if pts3d.dim() == 3 else 0,
        obs_uv.data_ptr(), 2 * n if obs_uv.dim() == 3 else 0,
        weights.data_ptr(), cam.data_ptr(), out.data_ptr(), b, n, iters,
        damping, threads, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gauss_newton")
    LAUNCHES["gauss_newton"] += 1
    return out
