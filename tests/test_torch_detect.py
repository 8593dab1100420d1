"""The PyTorch port's scene flow, clusterer and tracker against the JAX
package's (plain gather, XLA connected components and cluster stats)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import clusterer as jclu
from moving_object_detector_tpu import sceneflow as jsf
from moving_object_detector_tpu import tracker as jtr
from moving_object_detector_tpu.config import (
    ClustererConfig as JCluCfg,
    SceneFlowConfig as JSfCfg,
    TrackerConfig as JTrCfg,
)
from moving_object_detector_tpu.ops import geometry as jgeo
from moving_object_detector_tpu.types import (
    CameraModel as JCam,
    DisparityImage as JDisp,
    MovingObjects as JObj,
    SceneFlowCloud as JCloud,
)
from moving_object_detector_tpu_torch import clusterer as tclu
from moving_object_detector_tpu_torch import sceneflow as tsf
from moving_object_detector_tpu_torch import tracker as ttr
from moving_object_detector_tpu_torch.config import (
    ClustererConfig as TCluCfg,
    SceneFlowConfig as TSfCfg,
    TrackerConfig as TTrCfg,
)
from moving_object_detector_tpu_torch.ops import geometry as tgeo
from moving_object_detector_tpu_torch.types import (
    CameraModel as TCam,
    DisparityImage as TDisp,
    MovingObjects as TObj,
    SceneFlowCloud as TCloud,
)

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_scene_flow_matches():
    """Disparities with invalid holes, a flow that sends some pixels out of
    the image and some to NaN, and a small ego-motion: NaN pattern exact,
    values within 1e-5 (relative to magnitude)."""
    rng = np.random.default_rng(0)
    h, w = 40, 64
    d_now = rng.uniform(2, 30, (h, w)).astype(np.float32)
    d_prev = rng.uniform(2, 30, (h, w)).astype(np.float32)
    d_now[rng.random((h, w)) < 0.1] = -1.0
    d_prev[rng.random((h, w)) < 0.1] = -1.0
    flow = rng.normal(0, 6, (h, w, 2)).astype(np.float32)
    flow[:, :4, 0] = 20.0  # matches left of the image
    flow[rng.random((h, w)) < 0.05] = np.nan
    motion = np.eye(4, dtype=np.float32)
    motion[:3, 3] = [0.05, -0.02, 0.3]
    f, t = 200.0, 0.5
    out = {}
    for tag, disp, cam, geo, sf, cfg, arr in (
            ("j", JDisp, JCam.create(f, f, w / 2, h / 2), jgeo, jsf,
             JSfCfg(gather_backend="xla"), jnp.asarray),
            ("t", TDisp, TCam.create(f, f, w / 2, h / 2, device="cpu"), tgeo,
             tsf, TSfCfg(), torch.from_numpy)):
        dn = disp.create(arr(d_now), f=f, t=t, max_disparity=127.0)
        dp = disp.create(arr(d_prev), f=f, t=t, max_disparity=127.0)
        m = arr(motion)
        pn = geo.disparity_to_points(dn, cam)
        pp = geo.transform_points(m, geo.disparity_to_points(dp, cam))
        cloud, static = sf.construct_scene_flow(
            pn, pp, arr(flow), dn, dp, cam, 0.1, 2.0, transform_prev2now=m,
            config=cfg)
        out[tag] = [_np(cloud.points), _np(cloud.velocity), _np(static)]
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    vel = out["t"][1]
    assert np.isfinite(vel).any() and np.isnan(vel).any()
    assert (np.abs(np.nan_to_num(vel)) > 0).any()


def _blocks(h, w, blocks, seed=0):
    """Cloud with NaN background and textured blocks (y0, y1, x0, x1, z,
    vx): per-pixel velocity noise makes the median meaningful."""
    rng = np.random.default_rng(seed)
    pts = np.full((h, w, 3), np.nan, np.float32)
    vel = np.full((h, w, 3), np.nan, np.float32)
    for y0, y1, x0, x1, z, vx in blocks:
        ys, xs = np.mgrid[y0:y1, x0:x1]
        pts[y0:y1, x0:x1, 0] = xs * 0.01
        pts[y0:y1, x0:x1, 1] = ys * 0.01
        pts[y0:y1, x0:x1, 2] = z + rng.uniform(-0.02, 0.02, ys.shape)
        vel[y0:y1, x0:x1] = [vx, 0.1, 0.0]
        vel[y0:y1, x0:x1, 0] += rng.normal(0, 0.2, ys.shape)
    vel[rng.random((h, w)) < 0.02] = 0.05  # slow, static pixels
    return pts, vel


CASES = {
    # One window fits the dynamic extent.
    "busy": (48, 96, [(5, 15, 10, 30, 2.0, 1.0), (20, 30, 25, 45, 3.0, -1.5),
                      (8, 12, 60, 64, 1.0, 2.0)], dict(cc_crop_h=32,
                                                        cc_crop_w=64)),
    # Objects at opposite corners: the two-window split.
    "two_window": (48, 112, [(2, 12, 2, 22, 2.0, 1.0),
                             (34, 46, 80, 108, 3.0, -1.0),
                             (4, 8, 30, 38, 2.5, 1.2)],
                   dict(cc_crop_h=20, cc_crop_w=48)),
    # Crop disabled: the full-frame path, with capacity overflow.
    "full_frame": (40, 80, [(2 + 6 * i, 6 + 6 * i, 5 + 12 * i, 15 + 12 * i,
                             1.5 + 0.3 * i, 1.0 + 0.2 * i) for i in range(6)],
                   dict(cc_crop_h=0, cc_crop_w=0, max_objects=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_clusterer_matches(case):
    h, w, blocks, kw = CASES[case]
    pts, vel = _blocks(h, w, blocks)
    base = dict(cluster_size=12, max_objects=8)
    base.update(kw)
    jo, jl, jov = jclu.cluster_scene_flow(
        JCloud(points=jnp.asarray(pts), velocity=jnp.asarray(vel)),
        JCluCfg(cc_backend="xla", **base), return_overflow=True)
    to, tl, tov = tclu.cluster_scene_flow(
        TCloud(points=torch.from_numpy(pts), velocity=torch.from_numpy(vel)),
        TCluCfg(**base), return_overflow=True)
    np.testing.assert_array_equal(_np(tl), _np(jl))
    np.testing.assert_array_equal(_np(to.valid), _np(jo.valid))
    np.testing.assert_array_equal(_np(to.id), _np(jo.id))
    assert int(tov) == int(jov)
    for f in ("center", "bounding_box", "velocity"):
        np.testing.assert_allclose(_np(getattr(to, f)), _np(getattr(jo, f)),
                                   rtol=0, atol=1e-5)
    assert _np(to.valid).sum() >= 2
    if case == "full_frame":
        assert int(tov) == 2


def test_tracker_matches_over_five_frames():
    """Two objects moving at constant velocity plus one that appears late
    and one clutter detection: active mask exact, states within 1e-5."""
    cap = 6
    jcfg, tcfg = JTrCfg(max_tracks=8), TTrCfg(max_tracks=8)
    js, ts = jtr.TrackerState.create(8), ttr.TrackerState.create(8, "cpu")
    rng = np.random.default_rng(2)
    for k in range(5):
        t = 0.1 * k
        center = np.zeros((cap, 3), np.float32)
        velocity = np.zeros((cap, 3), np.float32)
        valid = np.zeros(cap, bool)
        for i, (p0, v) in enumerate((([1.0, 2.0], [1.0, 0.0]),
                                     ([-2.0, 4.0], [0.0, -0.8]))):
            center[i, :2] = np.add(p0, np.multiply(v, t)) + rng.normal(
                0, 0.02, 2)
            center[i, 2] = 5.0 + i
            velocity[i, :2] = v
            valid[i] = True
        if k >= 2:
            center[2] = [4.0, -1.0, 7.0]
            valid[2] = True
        center[3] = rng.uniform(-5, 5, 3)
        valid[3] = k % 2 == 0
        bbox = np.abs(rng.normal(1, 0.1, (cap, 3))).astype(np.float32)
        ids = np.where(valid, np.arange(cap), -1).astype(np.int32)
        jdet = JObj(id=jnp.asarray(ids), center=jnp.asarray(center),
                    velocity=jnp.asarray(velocity),
                    bounding_box=jnp.asarray(bbox), valid=jnp.asarray(valid))
        tdet = TObj(id=torch.from_numpy(ids), center=torch.from_numpy(center),
                    velocity=torch.from_numpy(velocity),
                    bounding_box=torch.from_numpy(bbox),
                    valid=torch.from_numpy(valid))
        js, jout = jtr.track_step(js, jnp.float32(t), jdet, jcfg)
        ts, tout = ttr.track_step(ts, t, tdet, tcfg)
        for f in ("active", "id", "correction_count", "next_id"):
            np.testing.assert_array_equal(_np(getattr(ts, f)),
                                          _np(getattr(js, f)), err_msg=f)
        for f in ("mean", "cov", "last_correction_time",
                  "last_prediction_time", "last_obs"):
            np.testing.assert_allclose(_np(getattr(ts, f)),
                                       _np(getattr(js, f)), rtol=0,
                                       atol=1e-5, err_msg=f)
        np.testing.assert_array_equal(_np(tout.objects.valid),
                                      _np(jout.objects.valid))
        np.testing.assert_allclose(_np(tout.objects.center),
                                   _np(jout.objects.center), atol=1e-5)
    assert _np(ts.active).sum() >= 3
    assert _np(tout.objects.valid).sum() >= 2


@pytest.mark.parametrize("shape,inf_frac", [((8, 5), 0.3), ((4, 9), 0.6),
                                             ((6, 6), 1.0)])
def test_greedy_association_matches(shape, inf_frac):
    """Best-first matching on the device: the same pairs as the JAX
    fori_loop, with ties (repeated costs) and gated (inf) entries."""
    rng = np.random.default_rng(3)
    cost = rng.integers(0, 6, shape).astype(np.float32) * -0.1
    cost[rng.random(shape) < inf_frac] = np.inf
    j = jtr._greedy_associate(jnp.asarray(cost))
    t = ttr._greedy_associate(torch.from_numpy(cost))
    np.testing.assert_array_equal(_np(t), _np(j))


def test_connected_components_radius_tensor():
    """A 0-d tensor neighbour radius below the stencil radius gates the
    edge set exactly like the JAX form."""
    from moving_object_detector_tpu.ops.clustering import (
        connected_components as jcc,
    )
    from moving_object_detector_tpu_torch.ops.clustering import (
        connected_components as tcc,
    )

    rng = np.random.default_rng(7)
    dyn = rng.random((30, 40)) < 0.3
    depth = rng.uniform(1, 1.2, (30, 40)).astype(np.float32)
    for nd in (0, 1, 3):
        a = jcc(jnp.asarray(dyn), jnp.asarray(depth), jnp.float32(0.15),
                neighbor_distance=jnp.int32(nd), stencil_radius=4)
        b = tcc(torch.from_numpy(dyn), torch.from_numpy(depth),
                torch.tensor(0.15), neighbor_distance=torch.tensor(nd),
                stencil_radius=4)
        np.testing.assert_array_equal(_np(b), _np(a))


def test_dataclass_replace_keeps_types():
    o = TObj.empty(3, "cpu")
    o2 = o.replace(valid=torch.ones(3, dtype=torch.bool))
    assert dataclasses.is_dataclass(o2) and bool(o2.valid.all())
