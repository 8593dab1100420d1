"""Ego-motion's Gauss-Newton pose solves and its RANSAC: wrappers of
``csrc/gauss_newton.cu`` and their plain versions.

``solve_pose``: ``iters`` damped Gauss-Newton updates of the
left-increment twist from the identity, for B problems at once: the
reprojection residuals of the moved points, the weighted normal
equations, a 6 x 6 Cholesky solve and the SE(3) exponential
left-multiplied onto the transform. ``ransac_solve``: the whole RANSAC of
``egomotion._ransac_gn_solve`` from given hypothesis indices, the
hypotheses' solves, their MSAC scores and inliers, the stable top-k, the
two-pass refinement of each candidate and the pick of the best. The
reference package compiles both inside its compiled ``estimate_motion``
(``egomotion.py:_solve_pose``, ``_ransac_gn_solve``); eagerly, the plain
versions dispatch some 250 small operations a Gauss-Newton iteration and
about 90 more for the scoring between a RANSAC's solves.

For CUDA tensors ``solve_pose`` launches the ``gauss_newton`` kernel
(all iterations of all problems in one launch) and ``ransac_solve`` the
``ransac_gn`` kernel (the whole RANSAC in one launch, no host sync), each
adding one to its ``LAUNCHES`` count; for CPU tensors they run the plain
versions ``solve_pose_plain`` and ``ransac_solve_plain``, whose
arithmetic the kernels repeat term by term. A failed build or launch
raises; so does what a kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import cuda_graphs
from . import geometry

LAUNCHES = {"gauss_newton": 0, "ransac_gn": 0}
THREADS = (32, 64, 128, 256)  # block sizes solve_pose takes
RANSAC_THREADS = (128, 256, 512)  # block sizes ransac_solve takes
RANSAC_DEFAULT_THREADS = 256
# The kernels' constants (csrc/gauss_newton.cu): the most warps a block,
# ransac_gn's blocks a cluster (they share the hypotheses), the most
# points of a problem solved by one thread, the shared memory a block can
# opt into on an H100, and the bytes of shared memory of the warps'
# partial sums and a transform, of ransac_gn's two flags, of a staged
# point and of a hypothesis' 3 x 4 transform a thread.
MAX_WARPS = 16
CLUSTER = 8
THREAD_POINTS = 8
SMEM_LIMIT = 232448
PART_BYTES = (MAX_WARPS * 32 + 16) * 4
MISC_BYTES = 16
POINT_BYTES = 24
HYP_BYTES = 48
# The C entries' parameters: pointers (and the stream), ints, floats.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOLVE_ARGTYPES = (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _F, _I, _P)
RANSAC_ARGTYPES = (_P,) * 10 + (_I,) * 6 + (_F,) * 4 + (_I, _I, _P)
CHECK_ARGTYPES = (ctypes.c_uint, _I, _P, _P)
_typed = False
_tickets: dict[tuple[int, int], torch.Tensor] = {}


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


def default_threads(n: int) -> int:
    """Threads a block for N points: one warp up to 32 points, else 128."""
    return 32 if n <= 32 else 128


def block_smem_bytes(n: int) -> int:
    """Shared memory of a ``gauss_newton`` block over N staged points."""
    return PART_BYTES + POINT_BYTES * n


def ransac_smem_bytes(n: int, threads: int) -> int:
    """Shared memory of a ``ransac_gn`` block: N staged points and their
    valid flags, a transform a thread."""
    return PART_BYTES + MISC_BYTES + HYP_BYTES * threads + (
        POINT_BYTES + 1) * n


def _refuse_beyond_smem(nbytes: int, n: int, what: str, per_point: int):
    if nbytes > SMEM_LIMIT:
        most = n + (SMEM_LIMIT - nbytes) // per_point
        raise ValueError(
            f"{what}: N = {n} points need {nbytes} bytes of shared memory, "
            f"over a block's limit of {SMEM_LIMIT}; it takes at most {most}")


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
        lib.gauss_newton.argtypes = list(SOLVE_ARGTYPES)
        lib.gauss_newton.restype = _I
        lib.ransac_gn.argtypes = list(RANSAC_ARGTYPES)
        lib.ransac_gn.restype = _I
        lib.ieee_ops_check.argtypes = list(CHECK_ARGTYPES)
        lib.ieee_ops_check.restype = _I
        _typed = True
    return lib


def solve_pose(pts3d, obs_uv, weights, cam, iters: int,
               damping: float = 1e-4, threads: int | None = None):
    """(B, 4, 4) poses: ``iters`` damped Gauss-Newton updates from the
    identity of B problems, each weighting N correspondences by its row of
    ``weights`` (B, N). ``pts3d`` (N, 3) / ``obs_uv`` (N, 2) are shared by
    all problems, or given per problem as (B, N, 3) / (B, N, 2); ``cam``
    is the (4,) vector of ``camera_vector``. One kernel launch for CUDA
    tensors (a thread a problem up to ``THREAD_POINTS`` points, else a
    block a problem, its points in shared memory), the plain version for
    CPU tensors."""
    if threads is None:
        threads = default_threads(weights.shape[-1])
    b, n = _check(pts3d, obs_uv, weights, cam, iters, threads)
    if weights.device.type == "cpu":
        return solve_pose_plain(pts3d, obs_uv, weights, cam, iters, damping)
    if n > THREAD_POINTS:
        _refuse_beyond_smem(block_smem_bytes(n), n, "solve_pose",
                            POINT_BYTES)
    if weights.device.type != "cuda":
        raise ValueError("the Gauss-Newton kernel takes CUDA tensors")
    return _launch_solve(pts3d, obs_uv, weights, cam, iters, damping,
                         threads, torch.cuda.current_stream().cuda_stream)


def _launch_solve(pts3d, obs_uv, weights, cam, iters, damping, threads,
                  stream):
    b, n = weights.shape
    pts3d, obs_uv, weights, cam = (x.contiguous() for x in
                                   (pts3d, obs_uv, weights, cam))
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=weights.device)
    rc = _lib().gauss_newton(
        pts3d.data_ptr(), 3 * n if pts3d.dim() == 3 else 0,
        obs_uv.data_ptr(), 2 * n if obs_uv.dim() == 3 else 0,
        weights.data_ptr(), cam.data_ptr(), out.data_ptr(), b, n, iters,
        damping, threads, stream)
    _build.check(rc, "gauss_newton")
    LAUNCHES["gauss_newton"] += 1
    return out


def _check_ransac(pts3d, tracked, feat_valid, cam, sample_idx, threads):
    """Raise on what ``ransac_gn`` does not take."""
    tensors = (pts3d, tracked, feat_valid, cam, sample_idx)
    if any(x.device != pts3d.device for x in tensors):
        raise ValueError("RANSAC inputs must be on one device")
    if any(x.dtype != torch.float32 for x in (pts3d, tracked, cam)):
        raise TypeError("pts3d, tracked and cam must be f32")
    if feat_valid.dtype != torch.bool:
        raise TypeError("feat_valid must be bool")
    if sample_idx.dtype != torch.int64:
        raise TypeError("sample_idx must be int64")
    n = pts3d.shape[0]
    if pts3d.dim() != 2 or n < 1 or pts3d.shape[1] != 3:
        raise ValueError(f"pts3d must be (N, 3) with N >= 1, not "
                         f"{tuple(pts3d.shape)}")
    if tuple(tracked.shape) != (n, 2) or tuple(feat_valid.shape) != (n,):
        raise ValueError(f"tracked must be ({n}, 2) and feat_valid ({n},), "
                         f"not {tuple(tracked.shape)} and "
                         f"{tuple(feat_valid.shape)}")
    if sample_idx.dim() != 2 or sample_idx.shape[0] < 1:
        raise ValueError(f"sample_idx must be (hypotheses, sample) with at "
                         f"least one hypothesis, not "
                         f"{tuple(sample_idx.shape)}")
    if tuple(cam.shape) != (4,):
        raise ValueError("cam must be the (4,) vector (fx, fy, cx, cy)")
    if threads not in RANSAC_THREADS:
        raise ValueError(f"threads must be one of {RANSAC_THREADS}")


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    """The zeroed ticket of this device and stream, made on first use:
    the kernel's last block leaves it 0, so calls on one stream, which run
    in order, can share it, and calls on two streams never do."""
    key = (dev.index, stream)
    ticket = _tickets.get(key)
    if ticket is None:
        ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
        _tickets[key] = ticket
    return ticket


def ransac_solve(pts3d, tracked, feat_valid, cam, sample_idx, cfg,
                 threads: int = RANSAC_DEFAULT_THREADS, out=None):
    """The RANSAC of ``egomotion._ransac_gn_solve`` from the hypothesis
    indices ``sample_idx`` (hypotheses, sample) int64 into the N features:
    ``pts3d`` (N, 3) and ``tracked`` (N, 2) f32, ``feat_valid`` (N,) bool,
    ``cam`` the (4,) vector of ``camera_vector``, ``cfg`` an
    ``EgoMotionConfig``. Returns (motion (4, 4) f32, success 0-d bool,
    inlier count 0-d int32) on the inputs' device, written into ``out``
    where given (three such tensors). For CUDA tensors one launch of
    ``ransac_gn`` and no host sync (an index outside [0, N) gives its
    hypothesis a NaN pose there), cut out of a running graph capture
    (``cuda_graphs.cut_point``); for CPU tensors the plain version."""
    _check_ransac(pts3d, tracked, feat_valid, cam, sample_idx, threads)
    if pts3d.device.type == "cpu":
        result = ransac_solve_plain(pts3d, tracked, feat_valid, cam,
                                    sample_idx, cfg)
        return result if out is None else tuple(
            o.copy_(r) for o, r in zip(out, result))
    n = pts3d.shape[0]
    _refuse_beyond_smem(ransac_smem_bytes(n, threads), n, "ransac_solve",
                        POINT_BYTES + 1)
    dev = pts3d.device
    if dev.type != "cuda":
        raise ValueError("the RANSAC kernel takes CUDA tensors")
    pts3d, tracked, feat_valid, cam, sample_idx = (
        x.contiguous() for x in (pts3d, tracked, feat_valid, cam,
                                 sample_idx))
    cut = cuda_graphs.cut_point(
        __name__, "ransac_solve",
        (pts3d, tracked, feat_valid, cam, sample_idx, cfg, threads),
        ((4, 4), (), ()), (torch.float32, torch.bool, torch.int32), dev)
    if cut is not None:
        return cut
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _launch_ransac(pts3d, tracked, feat_valid, cam, sample_idx, cfg,
                          threads, stream, _ticket(dev, stream), out)


def _launch_ransac(pts3d, tracked, feat_valid, cam, sample_idx, cfg, threads,
                   stream, ticket, out=None):
    n = pts3d.shape[0]
    h, s = sample_idx.shape
    k = ransac_candidates(cfg, h)
    th = cfg.inlier_threshold_px
    dev = pts3d.device
    clusters = -(-k // CLUSTER)
    scratch = torch.empty((clusters * 13 * h + 18 * k,), dtype=torch.float32,
                          device=dev)
    motion, success, count = out or (
        torch.empty((4, 4), dtype=torch.float32, device=dev),
        torch.empty((), dtype=torch.bool, device=dev),
        torch.empty((), dtype=torch.int32, device=dev))
    rc = _lib().ransac_gn(
        pts3d.data_ptr(), tracked.data_ptr(), feat_valid.data_ptr(),
        sample_idx.data_ptr(), cam.data_ptr(), scratch.data_ptr(),
        ticket.data_ptr(), motion.data_ptr(), success.data_ptr(),
        count.data_ptr(), n, h, s, k, cfg.gn_iters_hypothesis,
        cfg.gn_iters_refine, th, 0.5 * th, th ** 2, 1e-4,
        cfg.min_inliers, threads, stream)
    _build.check(rc, "ransac_gn")
    LAUNCHES["ransac_gn"] += 1
    return motion, success, count


def ieee_ops_check(n: int = 1 << 24, seed: int = 0,
                   device: str | torch.device = "cuda") -> dict:
    """The kernels' branch-free division and square root (``FastOps`` of
    ``csrc/gauss_newton.cu``, with the IEEE fallback its callers take)
    against the card's own ``a / b`` and ``sqrtf``, bit for bit, on ``n``
    hashed inputs from ``seed``: the mismatches and how many took the fast
    path. Launches one check kernel; CUDA only (it checks the card's
    arithmetic, which has no plain version)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("ieee_ops_check runs on a CUDA device")
    counts = torch.zeros((4,), dtype=torch.int32, device=device)
    rc = _lib().ieee_ops_check(seed, n, counts.data_ptr(),
                               torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "ieee_ops_check")
    div_bad, div_fast, sqrt_bad, sqrt_fast = counts.tolist()
    return dict(n=n, div_mismatches=div_bad, div_fast=div_fast,
                sqrt_mismatches=sqrt_bad, sqrt_fast=sqrt_fast)
