"""The PyTorch port's ego-motion against the JAX package's on a textured
plane seen after a known camera motion."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import egomotion as jego
from moving_object_detector_tpu.config import EgoMotionConfig as JCfg
from moving_object_detector_tpu.ops import geometry as jgeo
from moving_object_detector_tpu.types import (
    CameraModel as JCam,
    DisparityImage as JDisp,
)
from moving_object_detector_tpu_torch import egomotion as tego
from moving_object_detector_tpu_torch.config import EgoMotionConfig as TCfg
from moving_object_detector_tpu_torch.types import (
    CameraModel as TCam,
    DisparityImage as TDisp,
)

torch.set_num_threads(2)

H, W = 96, 128
FX = 150.0
CX, CY = W / 2.0, H / 2.0
BASELINE, Z0 = 0.5, 5.0
KW = dict(max_features=128, nms_radius=4, ransac_hypotheses=32,
          lk_pyramid_levels=2, min_inliers=10)
ROTVEC = [0.004, -0.008, 0.005]
TRANS = [0.02, -0.015, 0.04]


def _textured(rng):
    img = np.kron(rng.uniform(0.0, 1.0, (H // 8, W // 8)),
                  np.ones((8, 8))).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    for _ in range(2):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
        img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return img.astype(np.float32)


def _homography(rot, t):
    k = np.array([[FX, 0, CX], [0, FX, CY], [0, 0, 1.0]])
    return k @ (rot + np.outer(t, [0.0, 0.0, 1.0]) / Z0) @ np.linalg.inv(k)


def _scene():
    """(prev, now, prev-indexed exact flow, rotation) of the plane scene."""
    prev = _textured(np.random.default_rng(0))
    rot = np.asarray(jgeo.so3_exp(jnp.asarray(ROTVEC, jnp.float32)))
    hm = _homography(rot, np.asarray(TRANS))
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    pix = np.stack([uu, vv, np.ones_like(uu)], -1)
    src = pix @ np.linalg.inv(hm).T
    src = (src[..., :2] / src[..., 2:3]).reshape(-1, 2)
    now = np.asarray(jgeo.bilinear_sample(
        jnp.asarray(prev), jnp.asarray(src, jnp.float32))).reshape(H, W)
    dst = pix @ hm.T
    flow = (dst[..., :2] / dst[..., 2:3] - pix[..., :2]).astype(np.float32)
    return prev, now.astype(np.float32), flow, rot


def _disp(mod):
    return mod.create(np.full((H, W), FX * BASELINE / Z0, np.float32),
                      f=FX, t=BASELINE, min_disparity=0.0,
                      max_disparity=128.0)


JCAM = JCam.create(FX, FX, CX, CY)
TCAM = TCam.create(FX, FX, CX, CY, device="cpu")


def _rot_err(a, b):
    r = a[:3, :3] @ b[:3, :3].T
    return float(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))


def test_select_features_match():
    prev, _, _, _ = _scene()
    jp, jv = jego.select_features(jnp.asarray(prev), jnp.ones((H, W), bool),
                                  JCfg(**KW))
    tp, tv = tego.select_features(torch.from_numpy(prev),
                                  torch.ones((H, W), dtype=torch.bool),
                                  TCfg(**KW))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy()[tv.numpy()],
                                  np.asarray(jp)[np.asarray(jv)])


def test_ransac_with_injected_indices_matches():
    """Same correspondences and the JAX package's own hypothesis indices:
    the same motion within 1e-4."""
    rng = np.random.default_rng(3)
    n = 96
    cfg_j, cfg_t = JCfg(**KW), TCfg(**KW)
    pts3d = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 12, n)], 1).astype(np.float32)
    rot = np.asarray(jgeo.so3_exp(jnp.asarray(ROTVEC, jnp.float32)))
    moved = pts3d @ rot.T + np.asarray(TRANS, np.float32)
    uv = np.stack([FX * moved[:, 0] / moved[:, 2] + CX,
                   FX * moved[:, 1] / moved[:, 2] + CY], 1)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    uv[:10] += 15.0  # outliers
    valid = np.ones(n, bool)
    valid[-6:] = False
    key = jax.random.PRNGKey(11)
    p = valid.astype(np.float32) / valid.sum()
    keys = jax.random.split(key, cfg_j.ransac_hypotheses)
    idx = np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(cfg_j.ransac_sample,), replace=False,
        p=jnp.asarray(p)))(keys))
    jm, js, jc = jego._ransac_gn_solve(
        jnp.asarray(pts3d), jnp.asarray(uv), jnp.asarray(valid), JCAM, key,
        cfg_j)
    tm, ts, tc = tego._ransac_gn_solve(
        torch.from_numpy(pts3d), torch.from_numpy(uv),
        torch.from_numpy(valid), TCAM, None, cfg_t,
        sample_idx=torch.tensor(idx))
    assert bool(ts) and bool(js)
    assert int(tc) == int(jc)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)


@pytest.mark.parametrize("lk_fallback_frac", [0.5, 1.01],
                         ids=["dense_flow", "forced_lk_fallback"])
def test_estimate_motion_matches(lk_fallback_frac):
    """End to end on the known-motion plane: the dense-flow path, and the
    LK-fallback branch forced by a fallback fraction above 1. Hypotheses
    differ between the packages; the refined motions agree within 1e-3 rad
    and 1e-3 m."""
    prev, now, flow, rot = _scene()
    kw = dict(KW, lk_fallback_frac=lk_fallback_frac)
    jm, js, _ = jego.estimate_motion(
        jnp.asarray(prev), jnp.asarray(now), _disp(JDisp), JCAM,
        jax.random.PRNGKey(0), JCfg(**kw), dense_flow=jnp.asarray(flow))
    gen = torch.Generator().manual_seed(0)
    tm, ts, _ = tego.estimate_motion(
        torch.from_numpy(prev), torch.from_numpy(now), _disp(TDisp), TCAM,
        gen, TCfg(**kw), dense_flow=torch.from_numpy(flow))
    jm, tm = np.asarray(jm), tm.numpy()
    assert bool(ts) and bool(js)
    assert _rot_err(tm, jm) <= 1e-3
    assert np.abs(tm[:3, 3] - jm[:3, 3]).max() <= 1e-3
    assert _rot_err(tm, np.pad(rot, ((0, 1), (0, 1)))) <= 5e-3


def test_lk_track_matches():
    prev, now, _, _ = _scene()
    cfg = dict(KW)
    jp, jv = jego.select_features(jnp.asarray(prev), jnp.ones((H, W), bool),
                                  JCfg(**cfg))
    jt, jok = jego.lk_track(jnp.asarray(prev), jnp.asarray(now), jp,
                            JCfg(**cfg))
    tt, tok = tego.lk_track(torch.from_numpy(prev), torch.from_numpy(now),
                            torch.tensor(np.asarray(jp)), TCfg(**cfg))
    good = np.asarray(jv & jok) & tok.numpy()
    assert good.sum() > 20
    np.testing.assert_allclose(tt.numpy()[good], np.asarray(jt)[good],
                               rtol=0, atol=1e-3)


def test_failure_without_texture():
    flat = torch.full((H, W), 0.5)
    m, ok, _ = tego.estimate_motion(flat, flat, _disp(TDisp), TCAM,
                                    torch.Generator().manual_seed(0),
                                    TCfg(**KW))
    assert not bool(ok)
    np.testing.assert_allclose(m.numpy(), np.eye(4), atol=1e-6)
