"""The port's fused scene-flow construct against the JAX package's Pallas
kernel in interpret mode.

The plain version ``sceneflow_cuda.scene_flow_fused`` (which the CUDA
kernel is held against on the card) repeats the kernel's arithmetic in the
same order: NaN masks must be exact, values within 1e-5 (relative and
absolute; XLA on the CPU contracts multiply-adds, PyTorch does not). The
static flow is a projected pixel coordinate minus the pixel's own, so its
1e-5 is relative to the frame's extent: one ulp of a coordinate or a flow
near 200 is 1.5e-5, whatever is left after the subtraction. Scenes
have invalid disparities (NaN, zero, negative, out of range), NaN flow, a
non-trivial ego-motion and matches beyond the window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import sceneflow as jsf
from moving_object_detector_tpu.config import SceneFlowConfig as JSfCfg
from moving_object_detector_tpu.ops.sceneflow_pallas import (
    pack_params as jpack,
    scene_flow_fused_pallas,
)
from moving_object_detector_tpu.types import (
    CameraModel as JCam,
    DisparityImage as JDisp,
)
from moving_object_detector_tpu_torch import sceneflow as tsf
from moving_object_detector_tpu_torch.config import SceneFlowConfig as TSfCfg
from moving_object_detector_tpu_torch.ops import sceneflow_cuda
from moving_object_detector_tpu_torch.types import (
    CameraModel as TCam,
    DisparityImage as TDisp,
)
from sceneflow_cases import FUSED_CASES, fused_case

torch.set_num_threads(2)


def _rotation(omega):
    """Rodrigues formula in numpy, so neither package makes the input."""
    theta = np.linalg.norm(omega)
    k = np.asarray(omega) / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def _scene(h, w, seed, motion=True):
    rng = np.random.default_rng(seed)
    d_now = rng.uniform(1, 60, (h, w)).astype(np.float32)
    d_prev = rng.uniform(1, 60, (h, w)).astype(np.float32)
    d_now[3:6, 10:30] = np.nan
    d_now[8:10, :5] = 0.0
    d_prev[12:14, 40:80] = -2.0
    d_prev[0:2, :] = 200.0
    flow = rng.uniform(-6, 6, (h, w, 2)).astype(np.float32)
    flow[5:7, 50:60] = np.nan
    t = np.eye(4, dtype=np.float32)
    if motion:
        t[:3, :3] = _rotation([0.01, -0.02, 0.005])
        t[:3, 3] = [0.05, -0.02, 0.1]
    return d_now, d_prev, flow, t


def _sides(h, w, d_now, d_prev, t):
    """(cam, disp_now, disp_prev, transform, array maker) per package."""
    kw = dict(f=90.0, t=0.5, min_disparity=0.5, max_disparity=63.0)
    cam = (90.0, 95.0, w / 2 - 3, h / 2 + 2)
    j = (JCam.create(*cam), JDisp.create(jnp.asarray(d_now), **kw),
         JDisp.create(jnp.asarray(d_prev), **kw), jnp.asarray(t), jnp.asarray)
    p = (TCam.create(*cam, device="cpu"),
         TDisp.create(torch.from_numpy(d_now), **kw),
         TDisp.create(torch.from_numpy(d_prev), **kw), torch.from_numpy(t),
         torch.from_numpy)
    return j, p


def _assert_parity(port, ref):
    for a, b, name in zip(port, ref, ("points", "velocity", "static_flow")):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=f"{name} NaN mask")
        atol = 1e-5 * (max(a.shape[:2]) if name == "static_flow" else 1.0)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=name)


CASES = {
    "motion": dict(h=24, w=132, seed=11, motion=True),
    "identity": dict(h=16, w=128, seed=5, motion=False),
    "odd_shape": dict(h=37, w=171, seed=2, motion=True),
    "out_of_window": dict(h=16, w=128, seed=9, motion=False, vr=4, hr=16,
                          far=True),
    "disparity_rate": dict(h=24, w=132, seed=7, motion=True, rate=100.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_matches_pallas_interpret(case):
    c = CASES[case]
    h, w = c["h"], c["w"]
    vr, hr = c.get("vr", 8), c.get("hr", 64)
    rate = c.get("rate", 0.0)
    d_now, d_prev, flow, t = _scene(h, w, c["seed"], c["motion"])
    if c.get("far"):
        flow[10, 20, 0] = 40.0  # a match 40 px away, beyond the window
        flow[:, 100:, 0] = -300.0  # and some outside the image
    (jcam, jdn, jdp, jt, _), (tcam, tdn, tdp, tt, _) = _sides(
        h, w, d_now, d_prev, t)
    jpar = jpack(jcam, jdn, jdp, jt, jnp.float32(0.1), jnp.float32(5.0),
                 jnp.float32(rate))
    tpar = sceneflow_cuda.pack_params(tcam, tdn, tdp, tt, 0.1, 5.0, rate)
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
    ref = scene_flow_fused_pallas(jnp.asarray(d_now), jnp.asarray(d_prev),
                                  jnp.asarray(flow), jpar, v_radius=vr,
                                  h_radius=hr, interpret=True)
    out = sceneflow_cuda.scene_flow_fused_cuda(
        torch.from_numpy(d_now), torch.from_numpy(d_prev),
        torch.from_numpy(flow), tpar, v_radius=vr, h_radius=hr)
    _assert_parity(out, ref)
    vel = out[1].numpy()
    assert np.isfinite(vel).any() and np.isnan(vel).any()
    if c.get("far"):
        assert np.isnan(vel[10, 20]).all()
    if rate:
        off = sceneflow_cuda.scene_flow_fused(
            torch.from_numpy(d_now), torch.from_numpy(d_prev),
            torch.from_numpy(flow),
            sceneflow_cuda.pack_params(tcam, tdn, tdp, tt, 0.1, 5.0, 0.0),
            v_radius=vr, h_radius=hr)[1].numpy()
        both = np.isfinite(vel[..., 2]) & np.isfinite(off[..., 2])
        assert ((vel[..., 2] != off[..., 2]) & both).any()


@pytest.mark.parametrize("motion", [True, False], ids=["motion", "identity"])
def test_construct_scene_flow_fused_backend_matches_jax(motion):
    """``gather_backend="fused"`` on CPU tensors against the JAX package
    with ``"fused_interpret"``, through ``construct_scene_flow``; the
    clouds are not read on this path, so the port is given None."""
    h, w = 24, 132
    d_now, d_prev, flow, t = _scene(h, w, 13, motion)
    (jcam, jdn, jdp, jt, jarr), (tcam, tdn, tdp, tt, tarr) = _sides(
        h, w, d_now, d_prev, t)
    dummy = jnp.zeros((h, w, 3), jnp.float32)
    jc, js = jsf.construct_scene_flow(
        dummy, dummy, jarr(flow), jdn, jdp, jcam, jnp.float32(0.1),
        jnp.float32(5.0), transform_prev2now=jt,
        config=JSfCfg(gather_backend="fused_interpret", match_v_radius=8,
                      match_h_radius=64))
    tc, ts = tsf.construct_scene_flow(
        None, None, tarr(flow), tdn, tdp, tcam, 0.1, 5.0,
        transform_prev2now=tt,
        config=TSfCfg(gather_backend="fused", match_v_radius=8,
                      match_h_radius=64))
    _assert_parity((tc.points, tc.velocity, ts),
                   (jc.points, jc.velocity, js))


def test_fused_equals_the_windowed_composite_in_the_port():
    """Inside the port the fused construct and the composite with the
    windowed gather give the same NaN masks and values within 1e-5."""
    from moving_object_detector_tpu_torch.ops import geometry as tgeo

    h, w = 37, 171
    d_now, d_prev, flow, t = _scene(h, w, 21, True)
    _, (cam, dn, dp, tt, arr) = _sides(h, w, d_now, d_prev, t)
    pn = tgeo.disparity_to_points(dn, cam)
    pp = tgeo.transform_points(tt, tgeo.disparity_to_points(dp, cam))
    out = {}
    for backend in ("fused", "pallas"):
        cloud, static = tsf.construct_scene_flow(
            pn, pp, arr(flow), dn, dp, cam, 0.1, 5.0, transform_prev2now=tt,
            config=TSfCfg(gather_backend=backend, match_v_radius=8,
                          match_h_radius=64))
        out[backend] = (cloud.points, cloud.velocity, static)
    _assert_parity(out["fused"], out["pallas"])


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_edge_cases_plain_matches_pallas_interpret(case):
    """The CUDA kernel's edge shapes (tests/sceneflow_cases.py): widths
    with every residue mod 4, odd pixel counts, 1 x 1, 1 x 5, 3 x 7,
    matches on both sides of the covered window's edges, NaN and +-inf
    flow; the same parameter vector for both packages."""
    d_now, d_prev, flow, par, vr, hr = fused_case(case)
    ref = scene_flow_fused_pallas(jnp.asarray(d_now), jnp.asarray(d_prev),
                                  jnp.asarray(flow), jnp.asarray(par),
                                  v_radius=vr, h_radius=hr, interpret=True)
    out = sceneflow_cuda.scene_flow_fused_cuda(
        torch.from_numpy(d_now), torch.from_numpy(d_prev),
        torch.from_numpy(flow), torch.from_numpy(par), v_radius=vr,
        h_radius=hr)
    _assert_parity(out, ref)
    vel = out[1].numpy()
    assert np.isnan(vel).any()
    if d_now.size > 21:
        assert np.isfinite(vel).any()
