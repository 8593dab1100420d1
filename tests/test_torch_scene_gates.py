"""The scene-matrix gates the port's ``chip_smoke.py`` holds the six
``validation_scenes`` to (``tests/scene_gates.py``), against hand-made
metric dicts: each gate of ``scripts/validate_scene_matrix.py:96-132``
passes at its limit's good side and fails at the other, one case a gate;
the scene names are the port's ``validation_scenes``; and where the JAX
package fails gates itself, the phase wants the port to fail exactly
those. Numpy only.
"""

import copy

import pytest

from moving_object_detector_tpu_torch.io.scenes import validation_scenes

from scene_gates import (
    JAX_FAILS,
    SCENES,
    VEL_GATE,
    hit_fractions,
    matrix_verdict,
    scene_gates,
)


def _frame(k, hits, scoreable=None):
    """One ``detail_frames`` entry: object j scoreable (all by default)
    and hit as ``hits`` says."""
    idx = list(range(len(hits))) if scoreable is None else scoreable
    return {"k": k, "scoreable": [{"obj_index": j} for j in idx],
            "matched": list(hits), "phantoms": []}


def _metrics(n_objects=1, frames=8):
    return {"phantoms": 0, "ego_failures": 0, "d1": 0.02,
            "vel_err_median": 0.3, "center_err_median": 0.1,
            "detail_frames": [_frame(k, [True] * n_objects)
                              for k in range(frames)]}


def _failed(name, m, n_objects=1):
    return {g for g, _, _, ok in scene_gates(name, m, n_objects) if not ok}


def test_scene_names_are_the_ports_validation_scenes():
    assert tuple(validation_scenes(h=16, w=32, fx=10.0)) == SCENES


@pytest.mark.parametrize("name", SCENES)
def test_a_clean_scene_passes_every_gate(name):
    n = 2 if name in ("multi_object", "occlusion") else 1
    assert _failed(name, _metrics(n), n) == set()


@pytest.mark.parametrize("gate,key,good,bad", [
    ("phantoms", "phantoms", 0, 1),
    ("ego_failures", "ego_failures", 0, 1),
    ("d1", "d1", 0.0499, 0.05),
    ("vel_err_median", "vel_err_median", VEL_GATE - 1e-3, VEL_GATE),
    ("vel_err_median", "vel_err_median", 0.0, float("nan")),
    ("center_err_median", "center_err_median", 0.299, 0.3),
], ids=["phantom", "ego_failure", "d1", "velocity", "velocity_nan",
        "centre"])
def test_each_scalar_gate_fails_on_its_limit(gate, key, good, bad):
    m = _metrics()
    m[key] = good
    assert _failed("lateral", m) == set()
    m[key] = bad
    assert _failed("lateral", m) == {gate}


@pytest.mark.parametrize("name,floor", [("lateral", 0.8),
                                        ("occlusion", 0.5)])
def test_hit_fraction_gate_counts_scoreable_frames_only(name, floor):
    """Object 1 hit in ``floor`` of the frames where it is scoreable
    passes, one hit fewer fails; frames where it is not scoreable (hidden
    or out of view) count neither way."""
    frames = 10
    hits = round(floor * frames)
    m = _metrics(2, frames)
    m["detail_frames"] = [
        _frame(k, [True, k < hits]) for k in range(frames)] + [
        _frame(frames + k, [True], scoreable=[0]) for k in range(5)]
    assert hit_fractions(m, 2) == [1.0, hits / frames]
    assert _failed(name, m, 2) == set()
    m["detail_frames"][hits - 1]["matched"][1] = False
    assert _failed(name, m, 2) == {"obj1_hit"}


def test_an_object_never_scoreable_is_not_a_miss():
    m = _metrics(1)
    m["detail_frames"] = [_frame(k, [], scoreable=[]) for k in range(8)]
    assert hit_fractions(m, 1) == [None]
    assert _failed("rotating_cam", m) == set()


def test_approach_needs_two_of_its_last_three_scoreable_frames():
    """Late hits pass (the expansion flow crosses the dynamic gate late),
    early ones do not; frames without a scoreable object are skipped, and
    the per-object fraction is not gated in this scene."""
    m = _metrics(1)
    m["detail_frames"] = ([_frame(k, [False]) for k in range(5)]
                          + [_frame(5, [True]), _frame(6, [], []),
                             _frame(7, [False]), _frame(8, [True])])
    assert _failed("approach", m) == set()
    late = copy.deepcopy(m)
    late["detail_frames"][-1]["matched"] = [False]
    assert _failed("approach", late) == {"approach_hits_of_last_3"}
    early = copy.deepcopy(m)
    for k in range(5):
        early["detail_frames"][k]["matched"] = [True]
    early["detail_frames"][5]["matched"] = [False]
    assert _failed("approach", early) == {"approach_hits_of_last_3"}


@pytest.mark.parametrize("name", SCENES)
def test_the_phase_wants_the_jax_packages_outcome(name):
    """A scene the JAX package passes must pass every gate; one it fails
    (approach: velocity, rotating_cam: phantoms) must fail those gates
    and no other."""
    n = 2 if name in ("multi_object", "occlusion") else 1
    clean = _metrics(n)
    want = JAX_FAILS.get(name, set())
    assert (matrix_verdict(name, scene_gates(name, clean, n)) == []) \
        == (not want)
    as_jax = copy.deepcopy(clean)
    if "vel_err_median" in want:
        as_jax["vel_err_median"] = 1.255
    if "phantoms" in want:
        as_jax["phantoms"] = 12
    assert matrix_verdict(name, scene_gates(name, as_jax, n)) == []
    worse = copy.deepcopy(as_jax)
    worse["d1"] = 0.06
    assert matrix_verdict(name, scene_gates(name, worse, n)) == [
        "d1 fails (the JAX package passes it)"]
