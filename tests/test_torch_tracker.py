"""The port's tracker stage, ``tracker.track_frame``, on the CPU: bitwise
the plain reference (``portbench/reference/tracker.py``, the branch on
``frame_valid`` as its ``step.run_frame`` takes it) and the JAX package's
tracker within ``tests/test_torch_detect.py``'s tolerances, over
``tests/tracker_cases.py``'s sequences; no wait for the device. Its CUDA
graph's routing, bound, copy in and copy out are held, with the flow
stage's, in ``tests/test_torch_cuda_graphs.py``; the card's own graphs
bitwise to the eager stage in ``tests/test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import tracker as jtr
from moving_object_detector_tpu.config import TrackerConfig as JTrCfg
from moving_object_detector_tpu.types import MovingObjects as JObj
from moving_object_detector_tpu_torch import tracker as ttr
from moving_object_detector_tpu_torch.config import TrackerConfig as TTrCfg
from moving_object_detector_tpu_torch.types import MovingObjects as TObj
from moving_object_detector_tpu_torch.utils import profiling, trees
from portbench.reference import tracker as rtr
from portbench.reference import types as rtypes
from portbench.reference.config import TrackerConfig as RTrCfg
from tracker_cases import CASES

torch.set_num_threads(2)


def _dets(cls, frame, conv):
    _, center, velocity, bbox, valid, _ = frame
    ids = np.where(valid, np.arange(valid.shape[0]), -1).astype(np.int32)
    return cls(id=conv(ids), center=conv(center), velocity=conv(velocity),
               bounding_box=conv(bbox), valid=conv(valid))


def _equal(a, b):
    """Every tensor of two trees bitwise equal (NaN equal to NaN)."""
    la, lb = trees.leaves(a), trees.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()


def _reference_frame(state, frame, cfg):
    """The reference's tracker stage: ``track_step`` where the frame is
    valid, else the state and an empty output."""
    t, *_, frame_valid = frame
    if frame_valid:
        return rtr.track_step(state, float(t), _dets(
            rtypes.MovingObjects, frame, torch.from_numpy), cfg)
    k = state.capacity
    return state, rtypes.TrackedObjects(
        objects=rtypes.MovingObjects.empty(k, "cpu"),
        covariance=torch.zeros((k, 4, 4), dtype=torch.float32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_to_jax(ts, tout, js, jout):
    for f in ("active", "id", "correction_count", "next_id"):
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      _np(getattr(js, f)), err_msg=f)
    for f in ("mean", "cov", "last_correction_time",
              "last_prediction_time", "last_obs"):
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(_np(tout.objects.valid),
                                  _np(jout.objects.valid))
    np.testing.assert_array_equal(_np(tout.objects.id),
                                  _np(jout.objects.id))
    np.testing.assert_allclose(_np(tout.objects.center),
                               _np(jout.objects.center), rtol=0, atol=1e-5)


def _active(s):
    return int(s.active.sum())


# What each sequence must show, on the port's (state, output) a frame.
SHOWS = {
    # Slots 1 and 4 spawn; slot 2, 0.3 m from slot 1, does not.
    "adjacent_spawn": lambda h: (_active(h[0][0]) == 2
                                 and int(h[0][0].next_id) == 2),
    # Four of six spawn and fill the bank; none spawns after.
    "slots_full": lambda h: (bool(h[0][0].active.all())
                             and int(h[-1][0].next_id) == 4),
    # Frames 3 and 4: nothing corrected, spawned or published.
    "all_invalid": lambda h: (
        int(h[4][0].next_id) == int(h[2][0].next_id)
        and torch.equal(h[4][0].correction_count, h[2][0].correction_count)
        and not h[3][1].objects.valid.any() and _active(h[4][0]) == 2),
    # Track 1, unseen since frame 1, is pruned; track 0 stays.
    "pruned": lambda h: (_active(h[1][0]) == 2 and _active(h[-1][0]) == 1
                         and bool(h[-1][0].active[0])),
    # The invalid pairs keep the state and publish nothing.
    "frame_invalid": lambda h: (
        int(h[0][0].next_id) == 0
        and all(x.numpy().tobytes() == y.numpy().tobytes() for x, y in zip(
            trees.leaves(h[5][0]), trees.leaves(h[4][0])))
        and not h[5][1].objects.valid.any()
        and bool(h[4][1].objects.valid.any())),
    "serving": lambda h: (int(h[-1][0].next_id) >= 6
                          and any(bool(o.objects.valid.any())
                                  for _, o in h)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_track_frame_equals_the_reference_and_jax(name):
    make, cap = CASES[name]
    tcfg, rcfg = TTrCfg(max_tracks=cap), RTrCfg(max_tracks=cap)
    jcfg = JTrCfg(max_tracks=cap)
    ts = ttr.TrackerState.create(cap, "cpu")
    rs = rtr.TrackerState.create(cap, "cpu")
    js = jtr.TrackerState.create(cap)
    history = []
    for frame in make():
        t, frame_valid = frame[0], frame[-1]
        ts, tout = ttr.track_frame(
            ts, float(t), _dets(TObj, frame, torch.from_numpy),
            torch.tensor(frame_valid), tcfg)
        rs, rout = _reference_frame(rs, frame, rcfg)
        _equal((ts, tout), (rs, rout))
        if frame_valid:
            js, jout = jtr.track_step(js, jnp.float32(t),
                                      _dets(JObj, frame, jnp.asarray), jcfg)
            _close_to_jax(ts, tout, js, jout)
        history.append((ts, tout))
    assert SHOWS[name](history)


def test_track_frame_waits_for_nothing_and_counts_no_graph_on_the_cpu():
    """After its constants are built, a busy stage records no ``sync.*``
    site; CPU tensors build no graph and count 0 captures and replays."""
    make, cap = CASES["serving"]
    cfg = TTrCfg(max_tracks=cap)
    state = ttr.TrackerState.create(cap, "cpu")
    frames = make()
    ttr.track_frame(state, 0.0, _dets(TObj, frames[0], torch.from_numpy),
                    torch.tensor(True), cfg)
    with profiling.recording() as rec:
        for k, frame in enumerate(frames):
            profiling.set_unit(k)
            state, _ = ttr.track_frame(
                state, float(frame[0]), _dets(TObj, frame, torch.from_numpy),
                torch.tensor(frame[-1]), cfg)
    assert rec.n == 0 and not rec.counters[("syncs", 0)]
    for k in range(len(frames)):
        assert rec.counters[("tracker_graph_captures", k)] == 0
        assert rec.counters[("tracker_graph_replays", k)] == 0
        assert ("tracker_graph_replays", k) in rec.counters
    assert not ttr._tracker_cache.graphs

