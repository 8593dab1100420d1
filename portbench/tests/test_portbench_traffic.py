"""The serving traffic: the same seed renders the same pairs, two seeds
different ones, every seed the same sizes, depths and speeds."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from portbench.core import bench
from portbench.traffic import scene


def _params(pairs=4):
    p = copy.deepcopy(scene.params(bench.traffic_file("live_busy")))
    p.update(pairs=pairs, texture_hw=[40, 60])
    return p


def _render(seed, params=None):
    return scene.render(params or _params(), 48, 160, 92.7, 0.54, seed,
                        torch.device("cpu"))


def test_same_seed_same_pairs_and_different_seeds_differ():
    a, b = _render(2 ** 33 + 7), _render(2 ** 33 + 7)
    c = _render(2 ** 33 + 8)
    assert a.shape == (4, 2, 48, 160) and a.dtype == np.float32
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0


def test_views_differ_by_disparity_and_frames_by_motion():
    a = _render(11)
    assert not np.array_equal(a[0, 0], a[0, 1])
    assert not np.array_equal(a[0, 0], a[1, 0])


@pytest.mark.parametrize("mix", ["live_busy", "max_busy", "max_quiet"])
def test_seed_changes_arrangement_not_sizes(mix):
    p = scene.params(bench.traffic_file(mix))
    s1 = scene.Scene(p, 48, 160, 92.7, 0.54, 1, "cpu")
    s2 = scene.Scene(p, 48, 160, 92.7, 0.54, 2, "cpu")
    key = lambda s: [(m["z"], m["size"], m["span"], m["speed"])
                     for m in s.movers]
    assert key(s1) == key(s2) == [(m["z"], tuple(m["size"]),
                                   tuple(m["span"]), m["speed"])
                                  for m in p["movers"]]
    assert [m["phase"] for m in s1.movers] != [m["phase"]
                                                for m in s2.movers] or not p[
        "movers"]


def test_quiet_mix_is_busy_mix_without_movers():
    busy = bench.traffic_file("max_busy")
    quiet = bench.traffic_file("max_quiet")
    assert quiet["scene"] == busy["scene"] == "drive"
    assert quiet["scene_changes"] == {"movers": []}
    assert "scene_changes" not in busy
    assert len(scene.params(busy)["movers"]) == 6
    assert scene.params(quiet) == dict(scene.params(busy), movers=[])
    assert {k: v for k, v in quiet.items()
            if k not in ("scene_changes", "what")} == {
        k: v for k, v in busy.items() if k != "what"}


def test_playback_runs_forward_then_back():
    seq = [scene.playback(4, j) for j in range(10)]
    assert seq == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]


def test_pace_stays_within_its_span_at_its_speed():
    xs = [scene.pace(-2.0, 1.0, 1.5, 0.3, t / 15) for t in range(200)]
    assert min(xs) >= -2.0 and max(xs) <= 1.0
    steps = np.abs(np.diff(xs))
    assert steps.max() <= 1.5 / 15 + 1e-9
    assert np.median(steps) == pytest.approx(1.5 / 15)
