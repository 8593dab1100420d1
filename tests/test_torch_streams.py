"""The port's multi-stream step against the JAX package's.

``tests/test_spatial.py``'s scan configuration (48 x 96, two streams,
SGM D=16 and the flow net (8, 16, 32) in f32 on their plain forms, the
JAX random init carried across) runs three frames of a moving patch per
stream through both packages' ``detect_step_streams_scan``. Disparity
and label images must be equal; flow, ego-motion and the detections'
velocities are held with ``tests/test_torch_pipeline.py``'s tolerances
(the RANSAC draws differ between the packages, the motion within 1e-4).
The port's scan must also equal its batched form and each stream a
single-stream run, bit for bit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import config as jcfg
from moving_object_detector_tpu.models.pwc_net import (
    PWCNet as JPWCNet,
    init_pwc_params,
)
from moving_object_detector_tpu.parallel import streams as jstreams
from moving_object_detector_tpu.types import StereoModel as JStereo
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.parallel import streams
from moving_object_detector_tpu_torch.pipeline import (
    PipelineState,
    detect_step,
)
from moving_object_detector_tpu_torch.types import StereoModel
from moving_object_detector_tpu_torch.utils.checkpoint import params_from_flax
from test_torch_pipeline import _check, _flat

torch.set_num_threads(2)

H, W, N, FRAMES = 48, 96, 2, 3
FX, BASE, DT = 100.0, 0.48, 0.1
BG_D, OBJ_D, SHIFT = 5, 10, 4  # px: disparities, patch motion a frame
OBJ_Y, OBJ_H, OBJ_W = 16, 12, 16


def _config(m):
    """``tests/test_spatial.py:328``'s configuration."""
    return m.PipelineConfig(
        height=H, width=W,
        scene_flow=m.SceneFlowConfig(dynamic_flow_diff=2.0,
                                     gather_backend="xla"),
        clusterer=m.ClustererConfig(
            cluster_size=50, depth_diff=0.3, dynamic_speed=0.3,
            neighbor_distance=2, max_objects=4, cc_backend="xla"),
        tracker=m.TrackerConfig(max_tracks=8),
        sgm=m.SGMConfig(max_disparity=16, census_window=(5, 5),
                        backend="xla"),
        egomotion=m.EgoMotionConfig(
            max_features=64, nms_radius=2, ransac_hypotheses=8,
            lk_pyramid_levels=2, min_inliers=8),
        flownet=m.FlowNetConfig(
            feature_channels=(8, 16, 32), search_range=2,
            use_context_net=False, dtype="float32", corr_backend="xla"),
    )


def _smooth(img):
    k = np.array([0.25, 0.5, 0.25])
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return img.astype(np.float32)


def _frames():
    """(lefts, rights, flows) (FRAMES, N, H, W[, 2]): per stream a textured
    background at disparity BG_D and a patch at OBJ_D moving SHIFT px a
    frame, from the stream's own seed and start column; ``flows`` is the
    true flow (the patch's motion from frame 1 on)."""
    lefts = np.empty((FRAMES, N, H, W), np.float32)
    rights = np.empty_like(lefts)
    flows = np.zeros((FRAMES, N, H, W, 2), np.float32)
    for i in range(N):
        rng = np.random.default_rng(20 + i)
        bg = _smooth(rng.uniform(0.1, 0.9, (H, W)))
        obj = _smooth(rng.uniform(0.1, 0.9, (OBJ_H, OBJ_W)))
        for k in range(FRAMES):
            x = 30 + 6 * i + SHIFT * k
            left, right = bg.copy(), np.roll(bg, -BG_D, axis=1)
            left[OBJ_Y:OBJ_Y + OBJ_H, x:x + OBJ_W] = obj
            right[OBJ_Y:OBJ_Y + OBJ_H, x - OBJ_D:x - OBJ_D + OBJ_W] = obj
            lefts[k, i], rights[k, i] = left, right
            if k:
                flows[k, i, OBJ_Y:OBJ_Y + OBJ_H, x:x + OBJ_W, 0] = SHIFT
    return lefts, rights, flows


@pytest.fixture(scope="module")
def setup():
    jconfig, tconfig = _config(jcfg), _config(tcfg)
    jmodel = JPWCNet(config=jconfig.flownet)
    jparams = init_pwc_params(jmodel, H, W, jax.random.PRNGKey(0))
    model = PWCNet(tconfig.flownet)
    model.load_state_dict(params_from_flax(_flat(jparams)))
    stereo = StereoModel.create(FX, FX, W / 2, H / 2, BASE, device="cpu")
    jstereo = JStereo.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                             baseline=BASE)
    return types.SimpleNamespace(
        jconfig=jconfig, config=tconfig, jmodel=jmodel, jparams=jparams,
        model=model, stereo=stereo, jstereo=jstereo, frames=_frames())


def _ts(k):
    return torch.full((N,), k * DT)


def _run(setup, step, **kw):
    """Every frame through a multi-stream ``step``: (states, outputs) per
    frame, both stacked."""
    lefts, rights, _ = setup.frames
    states = streams.create_stream_states(setup.config, N, device="cpu")
    out = []
    for k in range(FRAMES):
        kw_k = {key: v[k] for key, v in kw.items()}
        states, o = step(setup.model, states, torch.from_numpy(lefts[k]),
                         torch.from_numpy(rights[k]), _ts(k), setup.stereo,
                         setup.config, **kw_k)
        out.append((states, o))
    return out


@pytest.fixture(scope="module")
def scan(setup):
    return _run(setup, streams.detect_step_streams_scan)


def _assert_trees_equal(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b) or (
            a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num())), what
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_trees_equal(getattr(a, f.name), getattr(b, f.name),
                                f"{what}.{f.name}")
    else:
        assert a == b, what


def _jax_pairs(setup, touts, step, **kw):
    """(JAX output, port output) per frame and stream, the JAX side from
    the multi-stream ``step`` over the same frames; label images equal."""
    lefts, rights, _ = setup.frames
    jstates = jstreams.create_stream_states(setup.jconfig, N)
    pairs = []
    for k in range(FRAMES):
        jstates, jout = step(
            setup.jparams, jstates, jnp.asarray(lefts[k]),
            jnp.asarray(rights[k]), jnp.full((N,), k * DT, jnp.float32),
            setup.jstereo, setup.jconfig, flow_model=setup.jmodel,
            **{key: jnp.asarray(v[k]) for key, v in kw.items()})
        for i, to in enumerate(streams.unstack_states(touts[k][1])):
            jo = jax.tree_util.tree_map(lambda x: x[i], jout)
            np.testing.assert_array_equal(to.label_image.numpy(),
                                          np.asarray(jo.label_image))
            pairs.append((jo, to))
    return pairs


def test_scan_matches_jax_scan(setup, scan):
    # Disparity bitwise, flow 1e-3, motion and detections 1e-4, validity,
    # overflow and ids equal.
    _check(_jax_pairs(setup, scan, jstreams.detect_step_streams_scan),
           flow_atol=1e-3)


def test_batched_with_true_flow_matches_jax_and_detects(setup):
    """The batched forms with the true flow as override: the patches are
    detected, on the same frames as in the JAX package."""
    flows = setup.frames[2]
    port = _run(setup, streams.detect_step_batched,
                flow_overrides=torch.from_numpy(flows))
    n_det = _check(_jax_pairs(setup, port, jstreams.detect_step_batched,
                              flow_overrides=flows), flow_atol=0.0)
    assert n_det >= N


def test_scan_equals_batched_bitwise(setup, scan):
    batched = _run(setup, streams.detect_step_batched)
    for (s1, o1), (s2, o2) in zip(scan, batched):
        _assert_trees_equal(o1, o2, "output")
        _assert_trees_equal(s1, s2, "state")


def test_each_stream_equals_a_single_stream_run(setup, scan):
    lefts, rights, _ = setup.frames
    for i in range(N):
        state = PipelineState.create(setup.config, device="cpu")
        for k in range(FRAMES):
            state, out = detect_step(
                setup.model, state, torch.from_numpy(lefts[k, i]),
                torch.from_numpy(rights[k, i]), k * DT, setup.stereo,
                setup.config)
            _assert_trees_equal(
                streams.unstack_states(scan[k][1])[i], out, f"frame {k}")
            _assert_trees_equal(
                streams.unstack_states(scan[k][0])[i], state,
                f"state {k}")


def test_stack_unstack_round_trip(scan):
    states, out = scan[-1]
    assert states.has_prev == (True,) * N
    assert states.frame_index == (FRAMES,) * N
    assert tuple(states.pose.shape) == (N, 4, 4)
    assert tuple(states.tracker.mean.shape[:1]) == (N,)
    assert tuple(out.detections.center.shape[:1]) == (N,)
    for tree in (states, out):
        parts = streams.unstack_states(tree)
        assert len(parts) == N
        _assert_trees_equal(streams.stack_states(parts), tree)
    first = streams.unstack_states(states)[0]
    assert first.frame_index == FRAMES and first.has_prev is True
    assert tuple(first.prev_left.shape) == (H, W)


def test_batched_refuses_cuda_tensors_and_pins_plain_forms(setup,
                                                           monkeypatch):
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="detect_step_streams_scan"):
        streams.detect_step_batched(None, None, fake, fake, None, None,
                                    setup.config)
    seen = []
    # A stub step that records the configuration it is given.
    monkeypatch.setattr(streams, "detect_step",
                        lambda *a, **k: seen.append(a[6]) or (a[1], a[1]))
    auto = setup.config.replace(
        sgm=dataclasses.replace(setup.config.sgm, backend="auto"),
        flownet=dataclasses.replace(setup.config.flownet,
                                    corr_backend="auto"),
        scene_flow=dataclasses.replace(setup.config.scene_flow,
                                       gather_backend="auto"),
        clusterer=dataclasses.replace(setup.config.clusterer,
                                      cc_backend="auto"))
    states = streams.create_stream_states(auto, 1, device="cpu")
    one = torch.zeros((1, H, W))
    streams.detect_step_batched(None, states, one, one, _ts(0)[:1], None,
                                auto)
    (cfg,) = seen
    assert (cfg.sgm.backend, cfg.flownet.corr_backend,
            cfg.scene_flow.gather_backend, cfg.clusterer.cc_backend) == \
        ("xla",) * 4
