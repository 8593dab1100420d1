"""The port's host loop (``io/runner.py``, ``run.py``, state snapshots)
against the JAX package's runner on the CLI's ``tiny`` preset.

Both runners get the same synthetic sequence and the same flow weights
(the JAX random init carried over by ``params_from_flax``); the port runs
on the CPU, as a caller must ask it to. Tolerances are those of
``tests/test_torch_pipeline.py``: flags and ids equal, centres, velocities
and boxes within 1e-4.
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from moving_object_detector_tpu import config as jcfg
from moving_object_detector_tpu.io.runner import PipelineRunner as JRunner
from moving_object_detector_tpu.models.pwc_net import (
    PWCNet as JPWCNet,
    init_pwc_params,
)
from moving_object_detector_tpu.types import StereoModel as JStereo
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch import run as trun
from moving_object_detector_tpu_torch.io import readers
from moving_object_detector_tpu_torch.io.runner import PipelineRunner
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.types import StereoModel
from moving_object_detector_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(2)

H, W, FX, BASE = 64, 128, 100.0, 0.48
N = 5


def _tiny(m):
    """The ``--preset tiny`` configuration of both CLIs."""
    return m.PipelineConfig(
        height=H, width=W,
        flownet=m.FlowNetConfig(feature_channels=(8, 16, 32), search_range=2,
                                use_context_net=False, dtype="float32"),
        sgm=m.SGMConfig(max_disparity=32),
        egomotion=m.EgoMotionConfig(max_features=64, nms_radius=2,
                                    ransac_hypotheses=8, lk_pyramid_levels=1,
                                    min_inliers=4),
    )


def _sequence(start=0, count=N):
    full = readers.SyntheticStereoSequence(
        height=H, width=W, fx=FX, baseline=BASE, z_bg=8.0, z_obj=4.0,
        obj_size=(24, 30), obj_speed_px=5.0, n_frames=start + count)
    return [full.frame(k)[:3] for k in range(start, start + count)]


def _flat(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def rig():
    """(JAX runner factory, port runner factory) sharing one set of flow
    weights."""
    jconfig, tconfig = _tiny(jcfg), _tiny(tcfg)
    jmodel = JPWCNet(config=jconfig.flownet)
    jparams = init_pwc_params(jmodel, H, W)
    tmodel = PWCNet(tconfig.flownet)
    tmodel.load_state_dict(checkpoint.params_from_flax(_flat(jparams)))
    tmodel.eval()
    kw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, baseline=BASE)
    jstereo = JStereo.create(**kw)
    tstereo = StereoModel.create(device="cpu", **kw)

    def jax_runner(**opts):
        return JRunner(jconfig, jstereo, jparams, jmodel, **opts)

    def port_runner(**opts):
        return PipelineRunner(tconfig, tstereo, tmodel, device="cpu", **opts)

    return jax_runner, port_runner


def _assert_results_match(port, ref, atol):
    assert [r.index for r in port] == [r.index for r in ref]
    for a, b in zip(port, ref):
        assert a.time == pytest.approx(b.time)
        assert a.frame_valid == b.frame_valid, a.index
        assert a.ego_success == b.ego_success, a.index
        assert a.cluster_overflow == b.cluster_overflow
        assert a.tracker_saturated == b.tracker_saturated
        assert a.n_detections == b.n_detections, a.index
        assert a.n_tracks == b.n_tracks, a.index
        for key in ("detections", "tracks"):
            da, db = getattr(a, key), getattr(b, key)
            np.testing.assert_array_equal(da["id"], np.asarray(db["id"]))
            for f in ("center", "velocity", "bounding_box"):
                np.testing.assert_allclose(da[f], np.asarray(db[f]), rtol=0,
                                           atol=atol,
                                           err_msg=f"{a.index} {key} {f}")
        np.testing.assert_allclose(a.tracks["covariance"],
                                   np.asarray(b.tracks["covariance"]),
                                   rtol=0, atol=max(atol, 1e-6))


@pytest.fixture(scope="module")
def jax_run(rig):
    runner = rig[0]()
    results = runner.run(_sequence())
    return runner, results


def test_runner_matches_the_jax_runner(rig, jax_run):
    results = rig[1]().run(_sequence())
    assert len(results) == N and results[0].index == 0
    assert not results[0].frame_valid and all(
        r.frame_valid for r in results[1:])
    _assert_results_match(results, jax_run[1], atol=1e-4)


def _oracle_flow(t):
    """The synthetic block's true flow at time t: 5 px a frame to the
    right inside its box, none elsewhere or on the first frame."""
    k = int(round(t * 10.0))
    flow = np.zeros((H, W, 2), np.float32)
    if k:
        x = W // 6 + 5 * k
        flow[H // 3:H // 3 + 24, x:x + 30, 0] = 5.0
    return flow


def _detecting(m):
    return _tiny(m).replace(
        scene_flow=m.SceneFlowConfig(dynamic_flow_diff=2.0),
        clusterer=m.ClustererConfig(cluster_size=100, depth_diff=0.3,
                                    neighbor_distance=2, max_objects=4),
        tracker=m.TrackerConfig(max_tracks=8),
        sgm=m.SGMConfig(max_disparity=32, backend="xla"),
        # Hypothesis draws differ between the packages, so enough of them
        # that neither side falls for the planar yaw / translation trade.
        egomotion=m.EgoMotionConfig(max_features=128, nms_radius=2,
                                    ransac_hypotheses=32,
                                    lk_pyramid_levels=2, min_inliers=8))


def test_runner_with_the_true_flow_detects_and_tracks_like_jax(monkeypatch):
    """Both runners, with ``detect_step`` given the block's true flow in
    place of the random-weight net's: the moving block is detected from
    frame 1 on and published as a track, the same in both."""
    import jax.numpy as jnp

    from moving_object_detector_tpu import pipeline as jpipe
    from moving_object_detector_tpu_torch import pipeline as tpipe

    jstep, tstep = jpipe.detect_step, tpipe.detect_step

    def jwrapped(params, state, left, right, t, *a, **kw):
        kw["flow_override"] = jnp.asarray(_oracle_flow(float(t)))
        return jstep(params, state, left, right, t, *a, **kw)

    def twrapped(model, state, left, right, t, *a, **kw):
        kw["flow_override"] = torch.from_numpy(_oracle_flow(float(t)))
        return tstep(model, state, left, right, t, *a, **kw)

    monkeypatch.setattr(jpipe, "detect_step", jwrapped)
    monkeypatch.setattr(tpipe, "detect_step", twrapped)
    kw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, baseline=BASE)
    ref = JRunner(_detecting(jcfg), JStereo.create(**kw)).run(
        _sequence(0, 7))
    out = PipelineRunner(_detecting(tcfg),
                         StereoModel.create(device="cpu", **kw),
                         device="cpu").run(_sequence(0, 7))
    _assert_results_match(out, ref, atol=1e-4)
    assert sum(r.n_detections for r in out) >= 5
    assert sum(r.n_tracks for r in out) >= 2
    assert out[-1].tracks["covariance"].shape == (out[-1].n_tracks, 4, 4)


def test_jax_state_carried_over_continues_to_the_same_frame(rig, jax_run):
    """The JAX runner's state after N frames, as numpy leaves, becomes the
    port's state; both then process frame N."""
    jrunner, _ = jax_run
    tree = jax.tree_util.tree_map(np.asarray, jrunner.final_state)
    state = checkpoint.pipeline_state_from_numpy(tree, device="cpu")
    assert state.frame_index == N and state.has_prev is True
    assert state.prev_left.dtype == torch.float32
    assert state.tracker.id.dtype == torch.int32
    nxt = _sequence(N, 1)
    ref = rig[0]().run(nxt, initial_state=jrunner.final_state)
    out = rig[1]().run(nxt, initial_state=state)
    assert [r.index for r in out] == [N]
    _assert_results_match(out, ref, atol=1e-4)
    as_dicts = {
        "pose": tree.pose, "prev_left": tree.prev_left,
        "prev_disparity": vars(tree.prev_disparity),
        "prev_time": tree.prev_time, "has_prev": tree.has_prev,
        "tracker": vars(tree.tracker), "frame_index": tree.frame_index}
    again = checkpoint.pipeline_state_from_numpy(as_dicts, device="cpu")
    assert torch.equal(again.prev_disparity.disparity,
                       state.prev_disparity.disparity)
    assert torch.equal(again.tracker.cov, state.tracker.cov)


def _exact(a, b):
    assert (a.index, a.time, a.frame_valid, a.ego_success, a.n_detections,
            a.n_tracks) == (b.index, b.time, b.frame_valid, b.ego_success,
                            b.n_detections, b.n_tracks)
    for key in ("detections", "tracks"):
        for f, va in getattr(a, key).items():
            np.testing.assert_array_equal(va, getattr(b, key)[f])


def test_snapshot_and_resume_reproduce_the_unbroken_run(rig, tmp_path):
    straight = rig[1]().run(_sequence(0, 6))
    first = rig[1]()
    head = first.run(_sequence(0, 3))
    snap = str(tmp_path / "state.npz")
    first.save_state(snap)
    assert os.path.isfile(snap)  # exactly the path asked for
    second = rig[1]()
    state = second.restore_state(snap)
    assert state.frame_index == 3 and state.pose.device.type == "cpu"
    tail = second.run(_sequence(3, 3), initial_state=state)
    assert [r.index for r in tail] == [3, 4, 5]
    for a, b in zip(straight, head + tail):
        _exact(a, b)


def test_snapshot_roundtrip_is_exact(rig, tmp_path):
    runner = rig[1]()
    runner.run(_sequence(0, 3))
    snap = str(tmp_path / "deep" / "dir" / "s.npz")
    runner.save_state(snap)
    back = checkpoint.restore_pipeline_state(snap, device="cpu")
    a, b = runner.final_state, back
    assert (a.has_prev, a.frame_index) == (b.has_prev, b.frame_index)
    for get in (lambda s: s.pose, lambda s: s.prev_left,
                lambda s: s.prev_time, lambda s: s.prev_disparity.disparity,
                lambda s: s.prev_disparity.max_disparity,
                lambda s: s.tracker.cov, lambda s: s.tracker.active,
                lambda s: s.tracker.correction_count):
        assert get(a).dtype == get(b).dtype and torch.equal(get(a), get(b))
    with pytest.raises(ValueError, match="directory"):
        checkpoint.restore_pipeline_state(str(tmp_path), device="cpu")


def test_feeder_error_surfaces_and_the_runner_is_reusable(rig):
    def broken():
        for k, frame in enumerate(_sequence(0, 4)):
            if k == 2:
                raise OSError("camera unplugged")
            yield frame

    runner = rig[1]()
    with pytest.raises(RuntimeError, match="frame feeder failed after 2"):
        runner.run(broken())
    assert len(runner.last_results) == 2
    assert runner.final_state.frame_index == 2
    assert isinstance(runner.__dict__["_token"].error, OSError)
    again = runner.run(_sequence(0, 3))
    assert [r.index for r in again] == [0, 1, 2]


def test_a_frame_of_the_wrong_size_is_a_feeder_error(rig):
    bad = [(np.zeros((H // 2, W), np.float32),) * 2 + (0.0,)]
    with pytest.raises(RuntimeError, match="frame feeder failed"):
        rig[1]().run(bad)


def test_max_frames_truncates_and_leaves_no_feeder(rig):
    runner = rig[1]()
    results = runner.run(_sequence(0, 6), max_frames=2)
    assert [r.index for r in results] == [0, 1]
    assert not runner._feeder_thread.is_alive()
    results = runner.run(_sequence(0, 3))  # no stale frame leaks in
    assert [r.time for r in results] == pytest.approx([0.0, 0.1, 0.2])


def test_exports_and_reconfigure_file(rig, tmp_path, capsys):
    knobs = tmp_path / "knobs.json"
    knobs.write_text(json.dumps({"dynamic_flow_diff": 2.5, "cluster_size": 40,
                                 "no_such_knob": 1}))
    runner = rig[1](export_dir=str(tmp_path / "out"), export_every=2,
                    reconfigure_file=str(knobs))
    runner.run(_sequence(0, 3))
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == sorted(
        f"{k:06d}_{kind}" for k in (0, 2) for kind in (
            "clusters.ppm", "flow.ppm", "static_flow.ppm", "depth.ppm",
            "velocity.ppm", "markers.json"))
    img = readers.read_pgm(str(tmp_path / "out" / "000002_depth.ppm"))
    assert img.shape == (H, W, 3)
    assert float(runner.tunables.dynamic_flow_diff) == 2.5
    assert int(runner.tunables.cluster_size) == 40
    assert runner.tunables.cluster_size.dtype == torch.int32
    assert "ignoring unknown keys ['no_such_knob']" in capsys.readouterr().out
    assert "dispatch" in runner.report() and "harvest" in runner.report()


def test_dashboard_hook_is_refused(rig):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rig[1](dashboard=object())


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = trun.main(argv, device="cpu")
    return rc, [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith("{")]


CLI = ["--source", "synthetic", "--preset", "tiny", "--height", str(H),
       "--width", str(W), "--fx", str(FX), "--baseline", str(BASE)]


def test_main_prints_one_json_line_per_frame(tmp_path):
    rc, lines = _main(CLI + ["--frames", "4", "--export-dir",
                             str(tmp_path / "out"), "--report"])
    assert rc == 0
    assert [r["frame"] for r in lines] == [0, 1, 2, 3]
    assert [r["time"] for r in lines] == [0.0, 0.1, 0.2, 0.3]
    assert [r["valid"] for r in lines] == [False, True, True, True]
    for r in lines:
        assert set(r) >= {"frame", "time", "valid", "ego", "detections",
                          "tracks"}
    assert "000000_markers.json" in os.listdir(tmp_path / "out")


def test_main_save_and_resume_equal_the_unbroken_run(tmp_path):
    snap = str(tmp_path / "s.npz")
    _, whole = _main(CLI + ["--frames", "5"])
    _, head = _main(CLI + ["--frames", "3", "--save-state", snap])
    _, tail = _main(CLI + ["--frames", "2", "--resume-state", snap])
    assert whole == head + tail and len(whole) == 5


def test_main_npz_source_with_crop(tmp_path):
    frames = _sequence(0, 3)
    pad = lambda img: np.pad(img, ((4, 4), (6, 6)))
    np.savez(tmp_path / "bag.npz", left=np.stack([pad(f[0]) for f in frames]),
             right=np.stack([pad(f[1]) for f in frames]),
             time=np.array([f[2] for f in frames]))
    _, cropped = _main(["--source", "npz", "--npz", str(tmp_path / "bag.npz"),
                        "--crop"] + CLI[2:] + ["--frames", "3"])
    _, direct = _main(CLI + ["--frames", "3"])
    assert cropped == direct


@pytest.mark.parametrize("argv,why", [
    (["--source", "interactive"], "--source interactive"),
    (["--serve-port", "0"], "--serve-port"),
])
def test_main_names_the_roadmap_for_unported_sources(argv, why, capsys):
    assert trun.main(argv, device="cpu") == 2
    err = capsys.readouterr().err
    assert why in err and "ROADMAP.md" in err


@pytest.mark.parametrize("argv", [["--source", "kitti"], ["--source", "npz"],
                                  ["--source", "socket"],
                                  ["--source", "live"]])
def test_main_asks_for_the_source_arguments(argv):
    assert trun.main(argv + ["--preset", "tiny"], device="cpu") == 2


def test_parser_has_the_flags_of_the_jax_cli():
    from moving_object_detector_tpu.run import build_parser as jparser

    flags = lambda p: {(tuple(a.option_strings), repr(a.default), a.nargs,
                        tuple(a.choices) if a.choices else None)
                       for a in p._actions}
    assert flags(trun.build_parser()) == flags(jparser())
    text = trun.build_parser().format_help()
    assert "torch.profiler" in text and ".npz" in text


def test_flow_checkpoint_resolution(tmp_path):
    auto = checkpoint.resolve_flow_checkpoint("auto")
    assert auto == checkpoint.default_flow_checkpoint()
    assert auto.endswith(os.path.join("weights", "pwc_v7.fp16.npz"))
    assert checkpoint.resolve_flow_checkpoint(None) == auto
    assert checkpoint.resolve_flow_checkpoint("none") is None
    assert checkpoint.resolve_flow_checkpoint("/x/w.npz") == "/x/w.npz"
    with pytest.raises(ValueError, match=r"\.npz"):
        checkpoint.resolve_flow_checkpoint(str(tmp_path))


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with profiling.trace_context(None):
        pass
    with profiling.trace_context(str(tmp_path / "trace")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_stage_timer_matches_the_jax_package():
    from moving_object_detector_tpu.utils.profiling import (
        StageTimer as JTimer,
    )

    a, b = profiling.StageTimer(), JTimer()
    for t in (a, b):
        for s in (0.01, 0.03, 0.02):
            t.add("sgm", s)
        t.add("flow", 0.5)
    assert a.summary() == b.summary() and a.report() == b.report()
