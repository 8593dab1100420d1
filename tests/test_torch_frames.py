"""The port's ``utils/frames.py`` against the JAX package's: the same
edges give the same lookups and transformed points (to 1e-12: both are
float64 numpy), and the same misuse raises the same errors."""

import numpy as np
import pytest

from moving_object_detector_tpu.utils import frames as jframes
from moving_object_detector_tpu_torch.utils import frames as tframes

TOL = 1e-12


def se3(rng):
    """A random rigid transform."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = np.eye(4)
    T[:3, :3] = q * np.sign(np.linalg.det(q))
    T[:3, 3] = rng.normal(size=3)
    return T


def _both(build):
    """``build(graph)`` run on a new graph of each package: [(graph,
    what build returned)], the JAX one first."""
    out = []
    for mod in (jframes, tframes):
        g = mod.FrameGraph()
        out.append((g, build(g)))
    return out


def _chain(g):
    """odom <- base <- cam <- lens, with an imu and a lidar beside cam."""
    rng = np.random.default_rng(1)
    g.update("odom", "base", se3(rng))
    g.add_static("base", "cam", se3(rng))
    g.add_static("cam", "lens", se3(rng))
    g.add_static("base", "imu", se3(rng))
    g.add_static("imu", "lidar", se3(rng))
    return [("odom", "lens"), ("lens", "odom"), ("cam", "imu"),
            ("lidar", "lens"), ("lens", "lidar"), ("base", "base"),
            ("imu", "odom")]


def _updated(g):
    """The chain, then three frames of odom -> base broadcasts."""
    pairs = _chain(g)
    rng = np.random.default_rng(2)
    for _ in range(3):
        g.update("odom", "base", se3(rng))
    return pairs


@pytest.mark.parametrize("build", [_chain, _updated],
                         ids=["chain", "dynamic_updates"])
def test_lookups_and_points_equal_the_jax_module(build):
    (jg, pairs), (tg, tpairs) = _both(build)
    assert pairs == tpairs and jg.frames() == tg.frames()
    pts = np.random.default_rng(3).normal(size=(16, 3))
    for target, source in pairs:
        np.testing.assert_allclose(tg.lookup(target, source),
                                   jg.lookup(target, source), rtol=0,
                                   atol=TOL, err_msg=f"{target}<-{source}")
        np.testing.assert_allclose(
            tg.transform_points(target, source, pts),
            jg.transform_points(target, source, pts), rtol=0, atol=TOL)


def test_pipeline_rig_roundtrip_equals_the_jax_module():
    """The detect_with_zed rig: odom <- base_link <- camera."""
    rng = np.random.default_rng(0)
    T_bc, odom_pose = se3(rng), se3(rng)
    pts_cam = rng.normal(size=(8, 3))
    got = []
    for mod in (jframes, tframes):
        g = mod.FrameGraph()
        g.add_static("base_link", "camera", T_bc)
        g.update("odom", "base_link", odom_pose)
        got.append(g.transform_points("odom", "camera", pts_cam))
    expected = pts_cam @ (odom_pose @ T_bc)[:3, :3].T + (
        odom_pose @ T_bc)[:3, 3]
    np.testing.assert_allclose(got[1], got[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1], expected, rtol=0, atol=TOL)


def _misuse(mod):
    g = mod.FrameGraph()
    g.add_static("base", "cam", np.eye(4))
    g.add_static("world2", "thing", np.eye(4))
    return [
        lambda: g.lookup("base", "nope"),
        lambda: g.lookup("cam", "thing"),
        lambda: g.add_static("world2", "cam", np.eye(4)),
        lambda: g.add_static("cam", "base", np.eye(4)),
        lambda: g.update("base", "cam", np.eye(4)),
        lambda: g.add_static("a", "b", np.eye(3)),
    ]


def test_errors_equal_the_jax_module():
    for jcall, tcall in zip(_misuse(jframes), _misuse(tframes)):
        with pytest.raises(Exception) as jerr:
            jcall()
        with pytest.raises(Exception) as terr:
            tcall()
        assert type(terr.value).__name__ == type(jerr.value).__name__
        assert str(terr.value) == str(jerr.value)
    assert issubclass(tframes.FrameGraphError, KeyError)
