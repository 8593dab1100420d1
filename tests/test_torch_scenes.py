"""The port's ``io/scenes.py`` against the JAX package's: the same
arguments and seed render bit-identical frames and truth (both are numpy
on the host), for the camera motions, background slope, occlusion and
real held-out textures the quality gates use; the canned validation
scenes; and the interactive scene under the same steering commands."""

import itertools
import os

import numpy as np
import pytest

from moving_object_detector_tpu.io import scenes as jscenes
from moving_object_detector_tpu_torch.io import scenes as tscenes

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "real_textures.npz")
H, W, FX = 96, 224, 150.0


def _heldout():
    data = np.load(FIXTURE)
    return {k: data[k].astype(np.float32) / 255.0
            for k in data.files if k.startswith("heldout_")}


def _texture(seed, h=64, w=96):
    return np.random.default_rng(seed).random((h, w)).astype(np.float32)


def _static(m):
    return m.PlanarSceneSequence(
        H, W, fx=FX, bg_depth=13.5, n_frames=3,
        objects=[m.PlaneObject(center0=(0.0, 0.0, 6.0), size=(1.2, 0.8),
                               velocity=(1.5, 0.0, 0.0),
                               texture=_texture(0))])


def _yawing(m):
    return m.PlanarSceneSequence(
        H, W, fx=FX, bg_depth=10.0, cam_velocity=(0.8, -0.1, 0.4),
        yaw_rate=np.deg2rad(3.0), n_frames=3, seed=4,
        objects=[m.PlaneObject(center0=(-0.5, 0.2, 7.0), size=(1.5, 1.0),
                               velocity=(1.0, 0.0, -1.0),
                               texture=_texture(1))])


def _sloped(m):
    tilt = np.deg2rad(25.0)
    return m.PlanarSceneSequence(
        H, W, fx=FX, bg_depth=10.0, n_frames=3,
        bg_normal=(0.0, np.sin(tilt), np.cos(tilt)),
        cam_velocity=(0.4, 0.0, 0.2), yaw_rate=np.deg2rad(1.5))


def _occlusion(m):
    return m.validation_scenes(h=H, w=W, fx=FX)["occlusion"]


def _heldout_sequence(m):
    """The held-out-texture sequence of tests/test_real_sequence.py."""
    tex = _heldout()
    return m.PlanarSceneSequence(
        H, W, fx=FX, bg_depth=12.0, bg_texture=tex["heldout_camera"],
        objects=[
            m.PlaneObject(center0=(-1.2, -0.75, 6.0), size=(2.0, 1.28),
                          velocity=(2.0, 0.0, 0.0),
                          texture=tex["heldout_blade"]),
            m.PlaneObject(center0=(0.55, 0.5, 6.5), size=(1.7, 1.1),
                          velocity=(0.2, 0.0, -4.0),
                          texture=tex["heldout_freedom"]),
        ],
        cam_velocity=(0.5, 0.0, 0.3), yaw_rate=np.deg2rad(1.5),
        fps=10.0, n_frames=7)


def _assert_equal(a, b, where):
    """Bitwise equality of nested truth values (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _assert_frames_equal(jseq, tseq, frames):
    for k in frames:
        for i, (a, b) in enumerate(zip(jseq.frame(k), tseq.frame(k))):
            _assert_equal(a, b, f"frame {k} item {i}")


@pytest.mark.parametrize("make", [_static, _yawing, _sloped, _occlusion,
                                  _heldout_sequence],
                         ids=["static_camera", "yawing_camera",
                              "sloped_background", "occlusion",
                              "heldout_textures"])
def test_frames_and_truth_bitwise_equal_the_jax_module(make):
    jseq, tseq = make(jscenes), make(tscenes)
    frames = range(jseq.n_frames) if jseq.n_frames <= 3 else (0, 1, 4, 6)
    _assert_frames_equal(jseq, tseq, frames)
    # The sequence protocol yields the same (left, right, t).
    for a, b in zip(itertools.islice(jseq, 2), itertools.islice(tseq, 2)):
        _assert_equal(a, b, "iter")


def test_validation_scenes_equal_the_jax_module():
    js = jscenes.validation_scenes(h=48, w=112, fx=75.0)
    ts = tscenes.validation_scenes(h=48, w=112, fx=75.0)
    assert list(ts) == list(js)
    for name in js:
        _assert_frames_equal(js[name], ts[name], (0, 3))
    textured = {"bg": _texture(5, 128, 128), "obj1": _texture(6)}
    js = jscenes.validation_scenes(h=48, w=112, fx=75.0, textures=textured)
    ts = tscenes.validation_scenes(h=48, w=112, fx=75.0, textures=textured)
    _assert_frames_equal(js["multi_object"], ts["multi_object"], (2,))
    np.testing.assert_array_equal(
        tscenes._procedural_texture(np.random.default_rng(9), 40, 50),
        jscenes._procedural_texture(np.random.default_rng(9), 40, 50))


def _interactive(m):
    return m.InteractiveSceneSequence(
        48, 128, fx=100.0, bg_depth=12.0, fps=10.0, realtime=False,
        n_frames=7,
        objects=[m.PlaneObject(
            center0=(0.0, 0.0, 6.0), size=(2.0, 1.2),
            velocity=(0.0, 0.0, 0.0),
            texture=m._procedural_texture(np.random.default_rng(3), 64, 96),
        )])


# Steering applied before the frame of the same index is pulled.
COMMANDS = {
    1: dict(obj_velocity=[[3.0, 0.0, 0.0]]),
    3: dict(obj_velocity=[[0.0, 0.0, 0.0]], cam_velocity=[0.0, 0.0, 1.0]),
    4: dict(yaw_rate=0.3, warp_drive=9),
    5: dict(obj_velocity=[None], cam_velocity=[0.5, 0.0, 0.0]),
}


def test_interactive_steering_equals_the_jax_module():
    jseq, tseq = _interactive(jscenes), _interactive(tscenes)
    jit, tit = iter(jseq), iter(tseq)
    moved = []
    for k in range(jseq.n_frames):
        if k in COMMANDS:
            _assert_equal(jseq.command(**COMMANDS[k]),
                          tseq.command(**COMMANDS[k]), f"command {k}")
        a, b = next(jit), next(tit)
        _assert_equal(a, b, f"frame {k}")
        _assert_equal(jseq.state(), tseq.state(), f"state {k}")
        moved.append(a[0])
    # The commands moved the rendered scene.
    assert not np.array_equal(moved[2], moved[3])
    assert not np.array_equal(moved[4], moved[5])
    tseq.stop()
    assert len(list(itertools.islice(tit, 3))) <= 1
