"""The port's Gauss-Newton pose solve (``ops/gauss_newton_cuda.py``)
against the JAX package's ``_solve_pose`` / ``_chol_solve6``, and its
wrapper on CPU tensors.

The inputs (tests/gauss_newton_cases.py) are correspondences of a known
camera motion at the RANSAC's two shapes, 64 hypotheses of 3 points and 4
candidates over 512 shared points, and at an odd size. Tolerances: 1e-5
abs on the transforms where every problem is well posed (the
refinement, the odd size); 1e-4 on the hypotheses, and only on the sound
ones (``gauss_newton_cases.sound``: converged to an exact fit in front of
the camera, condition number below ``COND_LIMIT``), since a 3-point
hypothesis can be ill-conditioned or unconverged and then an ulp of
difference in the sums (XLA on the CPU contracts multiply-adds and sums
in another order) moves it far.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import egomotion as jego
from moving_object_detector_tpu.types import CameraModel as JCam
from moving_object_detector_tpu_torch import egomotion as tego
from moving_object_detector_tpu_torch.config import EgoMotionConfig
from moving_object_detector_tpu_torch.ops import gauss_newton_cuda as gn
from moving_object_detector_tpu_torch.types import CameraModel as TCam
from gauss_newton_cases import (
    CAM,
    SHAPES,
    correspondences,
    problem,
    sound,
)

torch.set_num_threads(2)

JCAM = JCam.create(*CAM)
TCAM_VEC = torch.tensor(CAM, dtype=torch.float32)


def _jax_solve(pts, uv, weights, iters):
    """The JAX package's solve, vmapped over the problems as its RANSAC
    does; shared points broadcast."""
    b = weights.shape[0]
    if pts.ndim == 2:
        pts = np.broadcast_to(pts, (b,) + pts.shape)
        uv = np.broadcast_to(uv, (b,) + uv.shape)
    solve = jax.vmap(lambda p, o, w: jego._solve_pose(p, o, w, JCAM, iters))
    return np.asarray(solve(jnp.asarray(pts), jnp.asarray(uv),
                            jnp.asarray(weights)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_solve_matches_jax(shape):
    pts, uv, weights, iters = problem(shape)
    ref = _jax_solve(pts, uv, weights, iters)
    out = gn.solve_pose_plain(torch.from_numpy(pts), torch.from_numpy(uv),
                              torch.from_numpy(weights), TCAM_VEC,
                              iters).numpy()
    if shape == "hypothesis":
        keep = sound(out, pts, uv, weights)
        assert keep.sum() >= 16, keep.sum()
        np.testing.assert_allclose(out[keep], ref[keep], rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if shape == "refine":  # the known motion, from the inlier weights
        assert np.abs(out[:, 2, 3] - 0.6).max() < 0.02


def test_chol_solve6_matches_jax():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(16, 6, 6))
    a = (m @ m.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=(16, 6)).astype(np.float32)
    ref = np.asarray(jax.vmap(jego._chol_solve6)(jnp.asarray(a),
                                                 jnp.asarray(b)))
    out = tego._chol_solve6(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    exact = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(out.numpy(), exact, rtol=1e-4, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    before = dict(gn.LAUNCHES)
    pts, uv, weights, iters = problem("refine")
    args = (torch.from_numpy(pts), torch.from_numpy(uv),
            torch.from_numpy(weights), TCAM_VEC, iters)
    out = gn.solve_pose(*args)
    assert torch.equal(out, gn.solve_pose_plain(*args))
    assert torch.equal(out, tego._solve_pose(
        *args[:3], TCam.create(*CAM, device="cpu"), iters))
    assert gn.LAUNCHES == before


def _refusals():
    pts, uv = (torch.from_numpy(x) for x in correspondences(8))
    w = torch.ones(2, 8)
    cam = TCAM_VEC
    return {
        "f64_points": (pts.double(), uv, w, cam, 3, None),
        "points_of_four": (torch.ones(8, 4), uv, w, cam, 3, None),
        "observations_of_another_n": (pts, uv[:7], w, cam, 3, None),
        "per_problem_batch_mismatch": (pts.expand(3, 8, 3), uv, w, cam, 3,
                                       None),
        "weights_1d": (pts, uv, w[0], cam, 3, None),
        "no_problem": (pts, uv, w[:0], cam, 3, None),
        "camera_of_three": (pts, uv, w, cam[:3], 3, None),
        "negative_iters": (pts, uv, w, cam, -1, None),
        "threads_48": (pts, uv, w, cam, 3, 48),
        "int_weights": (pts, uv, w.int(), cam, 3, None),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    pts, uv, w, cam, iters, threads = _refusals()[case]
    with pytest.raises((ValueError, TypeError)):
        gn.solve_pose(pts, uv, w, cam, iters, threads=threads)


def test_ransac_calls_the_wrapper_at_its_three_sites(monkeypatch):
    """``_ransac_gn_solve`` makes one call of the RANSAC wrapper; its plain
    version calls the plain solve at the RANSAC's three sites: the
    hypotheses ((64, 3) points each) and each refinement pass ((4, 512)
    weights over the shared points)."""
    calls, ransac_calls = [], []
    real, real_ransac = gn.solve_pose_plain, gn.ransac_solve

    def spy(pts3d, obs_uv, weights, cam, iters, *a, **k):
        calls.append((tuple(pts3d.shape), tuple(weights.shape), iters))
        return real(pts3d, obs_uv, weights, cam, iters, *a, **k)

    def ransac_spy(pts3d, tracked, feat_valid, cam, sample_idx, cfg, **k):
        ransac_calls.append((tuple(pts3d.shape), tuple(sample_idx.shape)))
        return real_ransac(pts3d, tracked, feat_valid, cam, sample_idx, cfg,
                           **k)

    monkeypatch.setattr(gn, "solve_pose_plain", spy)
    monkeypatch.setattr(gn, "ransac_solve", ransac_spy)
    pts, uv = correspondences(512)
    cfg = EgoMotionConfig()
    motion, success, count = tego._ransac_gn_solve(
        torch.from_numpy(pts), torch.from_numpy(uv),
        torch.ones(512, dtype=torch.bool), TCam.create(*CAM, device="cpu"),
        torch.Generator().manual_seed(0), cfg)
    assert ransac_calls == [((512, 3), (64, 3))]
    assert calls == [((64, 3, 3), (64, 3), 5), ((512, 3), (4, 512), 8),
                     ((512, 3), (4, 512), 8)]
    assert bool(success) and int(count) > 400
    assert abs(float(motion[2, 3]) - 0.6) < 0.02
