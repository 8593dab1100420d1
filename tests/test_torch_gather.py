"""The port's windowed gather against the JAX package's Pallas kernel.

The plain version ``geometry.window_gather`` (which the CUDA kernel is held
against on the card) must equal ``window_gather_pallas(interpret=True)`` on
every input, NaN positions included: both use the covered window, so the
comparison is exact (tolerance 0), also for flows beyond the radius,
indices outside the image and NaN sources. Inside the guaranteed region it
must equal ``window_gather_reference``. ``construct_scene_flow`` with
``gather_backend="pallas"`` on CPU tensors is held against the JAX package
with ``"pallas_interpret"``: NaN masks exact, values within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import sceneflow as jsf
from moving_object_detector_tpu.config import SceneFlowConfig as JSfCfg
from moving_object_detector_tpu.ops import geometry as jgeo
from moving_object_detector_tpu.ops.gather_pallas import (
    window_gather_pallas,
    window_gather_reference,
)
from moving_object_detector_tpu.types import (
    CameraModel as JCam,
    DisparityImage as JDisp,
)
from moving_object_detector_tpu_torch import sceneflow as tsf
from moving_object_detector_tpu_torch.config import SceneFlowConfig as TSfCfg
from moving_object_detector_tpu_torch.ops import gather_cuda
from moving_object_detector_tpu_torch.ops import geometry as tgeo
from moving_object_detector_tpu_torch.types import (
    CameraModel as TCam,
    DisparityImage as TDisp,
)

torch.set_num_threads(2)


def _case(h, w, vr, hr, seed):
    """Indices from a bounded random flow, plus outliers far past the
    window, indices outside the image and NaN holes in the source."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(1.0, 100.0, (h, w)).astype(np.float32)
    src[rng.random((h, w)) < 0.05] = np.nan
    src[h // 2, :] = np.nan
    ii, jj = np.mgrid[0:h, 0:w]
    vp = ii + rng.integers(-(vr + 12), vr + 13, (h, w))
    up = jj + rng.integers(-(hr + 200), hr + 201, (h, w))
    far = rng.random((h, w)) < 0.05
    vp[far] = rng.integers(-3 * h, 4 * h, far.sum())
    up[far] = rng.integers(-3 * w, 4 * w, far.sum())
    return src, vp.astype(np.int32), up.astype(np.int32)


@pytest.mark.parametrize("h,w,vr,hr", [
    (16, 128, 8, 64),
    (24, 256, 16, 128),
    (30, 140, 8, 128),
    (37, 171, 16, 128),
    (64, 256, 5, 130),  # radii that are no multiples of the tile
    (17, 300, 0, 0),
])
def test_window_gather_equals_pallas_interpret(h, w, vr, hr):
    src, vp, up = _case(h, w, vr, hr, seed=h + w)
    out = gather_cuda.window_gather(
        torch.from_numpy(src), torch.from_numpy(vp), torch.from_numpy(up),
        v_radius=vr, h_radius=hr).numpy()
    ref = np.asarray(window_gather_pallas(
        jnp.asarray(src), jnp.asarray(vp), jnp.asarray(up), v_radius=vr,
        h_radius=hr, interpret=True))
    np.testing.assert_array_equal(out, ref)  # NaN positions included
    assert np.isfinite(out).any() and np.isnan(out).any()
    # Some hits lie beyond the nominal radius (the covered window is
    # wider), and everything in the guaranteed region equals the oracle.
    ii, jj = np.mgrid[0:h, 0:w]
    beyond = (np.abs(vp - ii) > vr) | (np.abs(up - jj) > hr)
    if vr % 8 or hr % 128 or vr == 0:
        assert np.isfinite(out[beyond]).any()
    oracle = np.asarray(window_gather_reference(
        jnp.asarray(src), jnp.asarray(vp), jnp.asarray(up), v_radius=vr,
        h_radius=hr))
    sure = np.isfinite(oracle)
    np.testing.assert_array_equal(out[sure], oracle[sure])
    outside = (vp < 0) | (vp >= h) | (up < 0) | (up >= w)
    assert outside.any() and np.isnan(out[outside]).all()


def test_window_gather_returns_nan_sources_as_nan():
    src, vp, up = _case(16, 128, 8, 64, seed=3)
    out = tgeo.window_gather(torch.from_numpy(src), torch.from_numpy(vp),
                             torch.from_numpy(up), 8, 64).numpy()
    inside = (vp >= 0) & (vp < 16) & (up >= 0) & (up < 128)
    assert np.isnan(out[inside & (vp == 8)]).all()


@pytest.mark.parametrize("h,w", [(24, 132), (37, 171)])
def test_scene_flow_windowed_backend_matches_jax(h, w):
    """Flows of up to 40 px against radii 8 / 16: many matches miss the
    window and lose their velocity, identically in both packages."""
    rng = np.random.default_rng(h)
    d_now = rng.uniform(2, 60, (h, w)).astype(np.float32)
    d_prev = rng.uniform(2, 60, (h, w)).astype(np.float32)
    d_prev[rng.random((h, w)) < 0.1] = -1.0
    flow = rng.uniform(-40, 40, (h, w, 2)).astype(np.float32)
    flow[rng.random((h, w)) < 0.05] = np.nan
    motion = np.eye(4, dtype=np.float32)
    motion[:3, 3] = [0.05, -0.02, 0.3]
    f, t = 100.0, 0.5
    out = {}
    for tag, disp, cam, geo, sf, cfg, arr in (
            ("j", JDisp, JCam.create(f, f, w / 2, h / 2), jgeo, jsf,
             JSfCfg(gather_backend="pallas_interpret", match_v_radius=8,
                    match_h_radius=16), jnp.asarray),
            ("t", TDisp, TCam.create(f, f, w / 2, h / 2, device="cpu"), tgeo,
             tsf, TSfCfg(gather_backend="pallas", match_v_radius=8,
                         match_h_radius=16), torch.from_numpy)):
        dn = disp.create(arr(d_now), f=f, t=t, max_disparity=63.0)
        dp = disp.create(arr(d_prev), f=f, t=t, max_disparity=63.0)
        m = arr(motion)
        pn = geo.disparity_to_points(dn, cam)
        pp = geo.transform_points(m, geo.disparity_to_points(dp, cam))
        cloud, static = sf.construct_scene_flow(
            pn, pp, arr(flow), dn, dp, cam, 0.1, 2.0, transform_prev2now=m,
            config=cfg)
        out[tag] = [np.asarray(cloud.points), np.asarray(cloud.velocity),
                    np.asarray(static)]
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    vel = out["t"][1]
    # The window really cut matches that the plain gather would keep.
    assert np.isfinite(vel).any()
    assert np.isnan(vel[..., 0]).mean() > 0.3
