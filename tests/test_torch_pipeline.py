"""The PyTorch port's detect_step against the JAX package's, end to end.

A tiny configuration (flow net (8, 16, 32) in f32 with the JAX random
init carried across, SGM D=16 on its plain form, plain gather and CC)
runs the same 4-frame moving-patch sequence through both packages, once
with the flow net and once with a flow override.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moving_object_detector_tpu import config as jcfg
from moving_object_detector_tpu.models.pwc_net import (
    PWCNet as JPWCNet,
    init_pwc_params,
)
from moving_object_detector_tpu.pipeline import (
    PipelineState as JState,
    detect_step as jdetect,
)
from moving_object_detector_tpu.types import StereoModel as JStereo
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.pipeline import (
    PipelineState,
    detect_step,
)
from moving_object_detector_tpu_torch.types import StereoModel
from moving_object_detector_tpu_torch.utils.checkpoint import params_from_flax

torch.set_num_threads(2)

H, W = 64, 128
FX, BASE = 100.0, 0.48
SHIFT, DT = 5, 0.1
OBJ_Y, OBJ_H, OBJ_W = 20, 24, 30
BG_STRIPS = ((0, 32, 6), (32, 64, 3), (64, 96, 9), (96, 128, 12))
D_OBJ = 12


def _config(m):
    return m.PipelineConfig(
        height=H, width=W,
        scene_flow=m.SceneFlowConfig(dynamic_flow_diff=2.0,
                                     gather_backend="xla"),
        clusterer=m.ClustererConfig(
            cluster_size=100, depth_diff=0.3, dynamic_speed=0.3,
            neighbor_distance=2, max_objects=4, cc_backend="xla"),
        tracker=m.TrackerConfig(max_tracks=8),
        sgm=m.SGMConfig(max_disparity=16, backend="xla"),
        egomotion=m.EgoMotionConfig(
            max_features=128, nms_radius=2, ransac_hypotheses=16,
            lk_pyramid_levels=2, min_inliers=8),
        flownet=m.FlowNetConfig(
            feature_channels=(8, 16, 32), search_range=2,
            use_context_net=False, dtype="float32", corr_backend="xla"),
    )


JCFG, TCFG = _config(jcfg), _config(tcfg)


def _smooth_noise(rng, h, w):
    img = rng.uniform(0.1, 0.9, (h, w)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return img.astype(np.float32)


def _frames(n):
    rng = np.random.default_rng(5)
    bg = _smooth_noise(rng, H, W)
    obj = _smooth_noise(rng, OBJ_H, OBJ_W)
    out = []
    for k in range(n):
        x = 30 + SHIFT * k
        left = bg.copy()
        left[OBJ_Y:OBJ_Y + OBJ_H, x:x + OBJ_W] = obj
        right = np.concatenate(
            [np.roll(bg, -d, axis=1)[:, a:b] for a, b, d in BG_STRIPS], 1)
        right[OBJ_Y:OBJ_Y + OBJ_H, x - D_OBJ:x - D_OBJ + OBJ_W] = obj
        flow = np.zeros((H, W, 2), np.float32)
        if k:
            flow[OBJ_Y:OBJ_Y + OBJ_H, x:x + OBJ_W, 0] = SHIFT
        out.append((left, right, flow))
    return out


def _flat(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat}


def _run(use_net: bool):
    jmodel = JPWCNet(config=JCFG.flownet)
    jparams = init_pwc_params(jmodel, H, W)
    tmodel = PWCNet(TCFG.flownet)
    tmodel.load_state_dict(params_from_flax(_flat(jparams)))
    jstereo = JStereo.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                             baseline=BASE)
    tstereo = StereoModel.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                                 baseline=BASE, device="cpu")
    js, ts = JState.create(JCFG), PipelineState.create(TCFG, device="cpu")
    pairs = []
    for k, (left, right, flow) in enumerate(_frames(4)):
        kw_j = {} if use_net else {"flow_override": jnp.asarray(flow)}
        kw_t = {} if use_net else {"flow_override": torch.from_numpy(flow)}
        js, jo = jdetect(jparams, js, jnp.asarray(left), jnp.asarray(right),
                         jnp.float32(k * DT), jstereo, JCFG,
                         flow_model=jmodel, **kw_j)
        ts, to = detect_step(tmodel, ts, torch.from_numpy(left),
                             torch.from_numpy(right), k * DT, tstereo, TCFG,
                             **kw_t)
        pairs.append((jo, to))
    return pairs


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(pairs, flow_atol):
    n_det = 0
    for k, (jo, to) in enumerate(pairs):
        np.testing.assert_array_equal(_np(to.disparity.disparity),
                                      _np(jo.disparity.disparity))
        np.testing.assert_allclose(_np(to.flow), _np(jo.flow), rtol=0,
                                   atol=flow_atol)
        np.testing.assert_allclose(_np(to.motion), _np(jo.motion), rtol=0,
                                   atol=1e-4)
        assert bool(to.frame_valid) == bool(jo.frame_valid), k
        assert int(to.cluster_overflow) == int(jo.cluster_overflow), k
        for tobj, jobj in ((to.detections, jo.detections),
                           (to.tracked.objects, jo.tracked.objects)):
            np.testing.assert_array_equal(_np(tobj.valid), _np(jobj.valid))
            np.testing.assert_array_equal(_np(tobj.id), _np(jobj.id))
            for f in ("center", "velocity", "bounding_box"):
                np.testing.assert_allclose(
                    _np(getattr(tobj, f)), _np(getattr(jobj, f)), rtol=0,
                    atol=1e-4, err_msg=f"frame {k} {f}")
        n_det += int(_np(to.detections.valid).sum())
    return n_det


def test_detect_step_matches_jax_with_flow_net():
    # f32 flow: the two packages' convolutions sum in different orders.
    _check(_run(use_net=True), flow_atol=1e-3)


def test_detect_step_matches_jax_with_flow_override():
    n_det = _check(_run(use_net=False), flow_atol=0.0)
    assert n_det >= 3  # the moving patch is detected from frame 1 on
