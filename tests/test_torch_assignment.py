"""The port's assignment solver, "gnn" tracker mode and center crop
against the JAX package's, on inputs from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import config as jcfg
from moving_object_detector_tpu import tracker as jtracker
from moving_object_detector_tpu import types as jtypes
from moving_object_detector_tpu.ops.assignment import (
    auction_assignment as jauction,
)
from moving_object_detector_tpu.ops.image import (
    center_crop_stereo as jcrop_stereo,
)
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch import tracker as ttracker
from moving_object_detector_tpu_torch import types as ttypes
from moving_object_detector_tpu_torch.ops.assignment import (
    auction_assignment,
    hungarian_assignment,
)
from moving_object_detector_tpu_torch.ops.image import (
    center_crop,
    center_crop_offsets,
    center_crop_stereo,
)

torch.set_num_threads(2)


def _both(cost):
    ref = np.asarray(jauction(jnp.asarray(cost)))
    out = auction_assignment(torch.from_numpy(cost))
    assert out.dtype == torch.int32
    return out.numpy(), ref


@pytest.mark.parametrize("seed", range(12))
def test_auction_equals_jax_on_seeded_costs(seed):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(1, 9), rng.integers(1, 9)
    cost = rng.uniform(-3, 1, (r, c)).astype(np.float32)
    cost = np.where(rng.uniform(size=(r, c)) < 0.35, np.inf,
                    cost).astype(np.float32)
    out, ref = _both(cost)
    np.testing.assert_array_equal(out, ref)
    used = out[out >= 0]
    assert len(used) == len(set(used.tolist()))
    assert all(np.isfinite(cost[i, m]) for i, m in enumerate(out) if m >= 0)


@pytest.mark.parametrize("shape", [(64, 16), (5, 40)])
def test_auction_equals_jax_at_the_tracker_shapes(shape):
    """Mostly forbidden pairs, as a gated association cost is; both the
    tall and the wide orientation of the port's unpadded solver."""
    rng = np.random.default_rng(sum(shape))
    cost = np.full(shape, np.inf, np.float32)
    open_ = rng.uniform(size=shape) < 0.08
    cost[open_] = -rng.uniform(0, 1, int(open_.sum())).astype(np.float32)
    out, ref = _both(cost)
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).sum() >= 3


def test_auction_all_forbidden():
    out, ref = _both(np.full((3, 4), np.inf, np.float32))
    np.testing.assert_array_equal(out, ref)
    assert (out == -1).all()


def test_auction_identity_diagonal():
    out, ref = _both(np.where(np.eye(4, dtype=bool), 0.0,
                              np.inf).astype(np.float32))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, [0, 1, 2, 3])


def test_auction_is_optimal_where_greedy_is_not():
    # Greedy takes (0, 0) first and is left with the costly (1, 1).
    cost = torch.tensor([[1.0, 2.0], [1.5, 10.0]])
    assert hungarian_assignment(cost).tolist() == [1, 0]
    assert ttracker._greedy_associate(cost).tolist() == [0, 1]


def _detections(m, centers, velocity):
    k = 8
    c = np.zeros((k, 3), np.float32)
    v = np.zeros((k, 3), np.float32)
    valid = np.zeros((k,), bool)
    c[:len(centers)] = centers
    v[:len(centers)] = velocity
    valid[:len(centers)] = True
    box = np.repeat(valid[:, None], 3, axis=1).astype(np.float32)
    ids = np.where(valid, np.arange(k), -1).astype(np.int32)
    conv = jnp.asarray if m is jtypes else torch.from_numpy
    return m.MovingObjects(id=conv(ids), center=conv(c), velocity=conv(v),
                           bounding_box=conv(box), valid=conv(valid))


def test_gnn_tracker_mode_matches_jax():
    """Two objects moving side by side over six frames through both
    trackers in "gnn" mode: the same published ids, centres within 1e-5."""
    jc = jcfg.TrackerConfig(max_tracks=8, association="gnn")
    tc = tcfg.TrackerConfig(max_tracks=8, association="gnn")
    js = jtracker.TrackerState.create(8)
    ts = ttracker.TrackerState.create(8, "cpu")
    published = 0
    for k in range(6):
        centers = np.array([[1.0 + 0.1 * k, 2.0, 5.0],
                            [3.0 + 0.1 * k, 2.3, 6.0]], np.float32)
        vel = np.array([1.0, 0.0, 0.0], np.float32)
        js, jout = jtracker.track_step(
            js, jnp.float32(0.1 * k), _detections(jtypes, centers, vel), jc)
        ts, tout = ttracker.track_step(
            ts, 0.1 * k, _detections(ttypes, centers, vel), tc)
        np.testing.assert_array_equal(tout.objects.valid.numpy(),
                                      np.asarray(jout.objects.valid))
        np.testing.assert_array_equal(tout.objects.id.numpy(),
                                      np.asarray(jout.objects.id))
        np.testing.assert_allclose(tout.objects.center.numpy(),
                                   np.asarray(jout.objects.center),
                                   rtol=0, atol=1e-5)
        published += int(tout.objects.valid.sum())
    assert published >= 4


def test_config_constructs_gnn_and_refuses_unknown_modes():
    assert tcfg.TrackerConfig(association="gnn").association == "gnn"
    with pytest.raises(ValueError, match="unknown association"):
        tcfg.TrackerConfig(association="jpda")


@pytest.mark.parametrize("shape,target", [((12, 20), (6, 9)),
                                          ((11, 21, 3), (11, 8)),
                                          ((9, 9), (9, 9))])
def test_center_crop_stereo_equals_jax(shape, target):
    rng = np.random.default_rng(sum(shape))
    left = rng.uniform(size=shape).astype(np.float32)
    right = rng.uniform(size=shape).astype(np.float32)
    kw = dict(fx=100.0, fy=101.0, cx=shape[1] / 2.0, cy=shape[0] / 2.0,
              baseline=0.5)
    jl, jr, jst = jcrop_stereo(jnp.asarray(left), jnp.asarray(right),
                               jtypes.StereoModel.create(**kw), *target)
    stereo = ttypes.StereoModel.create(device="cpu", **kw)
    tl, tr, tst = center_crop_stereo(torch.from_numpy(left),
                                     torch.from_numpy(right), stereo, *target)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    for f in ("fx", "fy", "cx", "cy"):
        assert float(getattr(tst.cam, f)) == float(getattr(jst.cam, f))
    assert float(tst.baseline) == float(jst.baseline)
    # numpy frames, as the CLI's --crop hands them over
    nl, nr, _ = center_crop_stereo(left, right, stereo, *target)
    np.testing.assert_array_equal(nl, np.asarray(jl))
    np.testing.assert_array_equal(nr, np.asarray(jr))


def test_center_crop_offsets_and_oversize():
    assert center_crop_offsets(10, 21, 4, 10) == (3, 5)
    img = torch.zeros(4, 4)
    cam = ttypes.CameraModel.create(1.0, 1.0, 2.0, 2.0, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        center_crop(img, cam, 5, 4)
