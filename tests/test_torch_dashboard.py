"""The port's live dashboard (``io/dashboard.py``), its runner hooks and
the CLI's ``--source interactive`` / ``--serve-port``, after the JAX
package's tests in ``tests/test_io.py``.

The dashboard draws from the host copy the runner's harvest fetches, so
the same host frame must give the JAX module's PNGs byte for byte. The
runner runs on the CPU here, as a caller must ask it to; that a harvest
launches no kernel with the dashboard is checked on the card by
``tests/test_torch_kernels_gpu.py`` (and ``chip_smoke.py``).
"""

import contextlib
import io
import json
import re
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from moving_object_detector_tpu.io import dashboard as jdash
from moving_object_detector_tpu_torch import config as tcfg
from moving_object_detector_tpu_torch import pipeline
from moving_object_detector_tpu_torch import run as trun
from moving_object_detector_tpu_torch.io import dashboard as tdash
from moving_object_detector_tpu_torch.io import readers, scenes
from moving_object_detector_tpu_torch.io.runner import PipelineRunner
from moving_object_detector_tpu_torch.models.pwc_net import PWCNet
from moving_object_detector_tpu_torch.types import StereoModel

torch.set_num_threads(2)

H, W, FX = 32, 64, 50.0


def _config():
    """The JAX dashboard tests' tiny configuration."""
    return tcfg.PipelineConfig(
        height=H, width=W,
        flownet=tcfg.FlowNetConfig(feature_channels=(8, 16, 32),
                                   search_range=2, use_context_net=False,
                                   dtype="float32"),
        sgm=tcfg.SGMConfig(max_disparity=16),
        egomotion=tcfg.EgoMotionConfig(max_features=32, nms_radius=2,
                                       ransac_hypotheses=8,
                                       lk_pyramid_levels=1, min_inliers=4))


def _runner(dashboard, device="cpu", **kw):
    config = _config()
    torch.manual_seed(0)
    model = PWCNet(config.flownet).eval()
    stereo = StereoModel.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                                baseline=0.5, device=device)
    return PipelineRunner(config, stereo, model.to(device),
                          dashboard=dashboard, device=device, **kw)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=5).read()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=body, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=5).read())


@contextlib.contextmanager
def _dashboard(cls=tdash.LiveDashboard):
    dash = cls(0, host="127.0.0.1")
    try:
        yield dash, f"http://127.0.0.1:{dash.port}"
    finally:
        dash.close()


def test_dashboard_serves_products_from_the_port_runner():
    with _dashboard() as (dash, base):
        assert b"moving_object_detector_tpu" in _get(base, "/")
        for name in tdash.LiveDashboard.PRODUCTS:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base, f"/view/{name}.png")
            assert e.value.code == 404  # nothing rendered yet
        seq = readers.SyntheticStereoSequence(height=H, width=W, fx=FX,
                                              n_frames=3)
        runner = _runner(dash)
        runner.run(seq, max_frames=3)
        status = json.loads(_get(base, "/status.json"))
        assert status["frame"] == 2 and status["frame_valid"] is True
        for name in tdash.LiveDashboard.PRODUCTS:
            assert _get(base, f"/view/{name}.png").startswith(b"\x89PNG")
        assert len(runner.timer.samples["dashboard"]) == 3


def _host_frame(rng):
    """A frame's outputs as numpy arrays, with detections and tracks in
    view and one of each behind the camera."""
    def objects(n):
        center = rng.normal(0, 0.5, (n, 3)) + [0, 0, 5]
        center[1, 2] = -1.0
        return types.SimpleNamespace(
            valid=np.array([True, True, True, False]), center=center,
            velocity=rng.normal(0, 1, (n, 3)),
            bounding_box=rng.uniform(0.5, 1.5, (n, 3)))

    pose = np.eye(4)
    pose[:3, 3] = [0.3, 0.0, -0.2]
    return types.SimpleNamespace(
        detections=objects(4),
        tracked=types.SimpleNamespace(objects=objects(4)),
        odom_pose=pose,
        label_image=rng.integers(-1, 5, (H, W)).astype(np.int32),
        flow=rng.normal(0, 3, (H, W, 2)).astype(np.float32),
        scene_flow=types.SimpleNamespace(
            points=rng.normal(0, 1, (H, W, 3)).astype(np.float32) + 4),
        ego_success=np.array(True), frame_valid=np.array(True))


def test_products_equal_the_jax_dashboard_byte_for_byte():
    rng = np.random.default_rng(0)
    out = _host_frame(rng)
    left = rng.random((H, W)).astype(np.float32)
    cam = types.SimpleNamespace(fx=np.float32(FX), fy=np.float32(FX),
                                cx=np.float32(W / 2), cy=np.float32(H / 2))
    stereo = types.SimpleNamespace(cam=cam)
    config = _config()
    with _dashboard(jdash.LiveDashboard) as (jd, jbase), \
            _dashboard() as (td, tbase):
        for k in range(2):
            jd.update(k, 0.1 * k, out, left, config, stereo)
            td.update(k, 0.1 * k, out, left, config, stereo)
        for name in tdash.LiveDashboard.PRODUCTS:
            assert (_get(tbase, f"/view/{name}.png")
                    == _get(jbase, f"/view/{name}.png")), name
        js = json.loads(_get(jbase, "/status.json"))
        ts = json.loads(_get(tbase, "/status.json"))
        js.pop("throughput_fps"), ts.pop("throughput_fps")
        assert ts == js
        assert _get(tbase, "/") == _get(jbase, "/").replace(
            b"moving_object_detector_tpu", b"moving_object_detector_tpu_torch")
        # A NaN member (which stops the JAX module's update) is skipped:
        # the view equals the one without that object.
        out.detections.center[2] = np.nan
        td.update(2, 0.2, out, left, config, stereo)
        with_nan = _get(tbase, "/view/camera.png")
        out.detections.valid[2] = False
        td.update(3, 0.3, out, left, config, stereo)
        assert with_nan == _get(tbase, "/view/camera.png")


class _Recording(tdash.LiveDashboard):
    """A dashboard that keeps what the runner hands it and POSTs a retune
    from the harvest of frame ``post_at``."""

    post_at = 1

    def update(self, index, t, out, left, config, stereo):
        self.seen = getattr(self, "seen", []) + [(out, stereo)]
        if index == self.post_at:
            _post(f"http://127.0.0.1:{self.port}", "/tunables",
                  json.dumps({"dynamic_speed": 0.77}).encode())
        super().update(index, t, out, left, config, stereo)


def _leaves(node):
    if isinstance(node, (np.ndarray, np.generic)):
        yield node
    elif hasattr(node, "__dataclass_fields__"):
        for name in node.__dataclass_fields__:
            yield from _leaves(getattr(node, name))
    elif isinstance(node, types.SimpleNamespace):
        for v in vars(node).values():
            yield from _leaves(v)
    elif node is not None and not isinstance(node, (int, float)):
        raise AssertionError(f"not a host value: {type(node)}")


def test_retune_is_applied_by_the_next_frame(monkeypatch):
    """A POST to /tunables during frame k's harvest (after frame k + 1 is
    dispatched) rides into frame k + 2; /tunables.json shows the host
    mirror; the dashboard sees host arrays only."""
    seen = []
    real = pipeline.detect_step

    def spy(*args, tunables=None, **kw):
        seen.append(float(tunables.dynamic_speed))
        return real(*args, tunables=tunables, **kw)

    monkeypatch.setattr(pipeline, "detect_step", spy)
    with _dashboard(_Recording) as (dash, base):
        assert _post(base, "/tunables", json.dumps(
            {"cluster_size": 123.7, "not_a_knob": 1.0}).encode()) == {
                "queued": ["cluster_size", "not_a_knob"]}
        runner = _runner(dash)
        runner.run(readers.SyntheticStereoSequence(
            height=H, width=W, fx=FX, n_frames=5))
        default = tcfg.ClustererConfig().dynamic_speed
        assert seen == [pytest.approx(default)] * 3 + [
            pytest.approx(0.77)] * 2
        assert int(runner.tunables.cluster_size) == 123
        view = json.loads(_get(base, "/tunables.json"))
        assert view == runner.tunable_values
        assert view["cluster_size"] == 123.0
        assert view["dynamic_speed"] == float(np.float32(0.77))
        for field in runner.tunables.__dataclass_fields__:
            assert view[field] == float(getattr(runner.tunables, field))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/tunables", b"[1,2]")
        assert e.value.code == 400
        for out, stereo in dash.seen:
            assert all(isinstance(x, (np.ndarray, np.generic))
                       for x in _leaves(out))
            assert list(_leaves(stereo))
            assert out.disparity is None and out.static_flow is None


def _interactive():
    rng = np.random.default_rng(5)
    return scenes.InteractiveSceneSequence(
        H, W, fx=FX, bg_depth=12.0, fps=10.0, realtime=False, n_frames=6,
        objects=[scenes.PlaneObject(
            center0=(0.0, 0.0, 6.0), size=(1.0, 0.8),
            velocity=(0.0, 0.0, 0.0),
            texture=scenes._procedural_texture(rng, 64, 96))])


def test_sim_endpoint_steers_the_interactive_scene():
    with _dashboard() as (dash, base):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/sim", b'{"yaw_rate": 0.2}')
        assert e.value.code == 409  # no sim attached
        seq = _interactive()
        dash.set_sim_handler(seq.command)
        columns = []

        def tap(frames):
            for k, frame in enumerate(frames):
                # The object's pixels in the rendered truth.
                pid = seq._cast(k, right=False)[2]
                columns.append(np.nonzero(pid == 0)[1].mean())
                if k == 1:
                    state = _post(base, "/sim", json.dumps(
                        {"obj_velocity": [[2.0, 0.0, 0.0]],
                         "warp_drive": 9}).encode())
                    assert state["obj_velocity"] == [[2.0, 0.0, 0.0]]
                yield frame

        results = _runner(dash).run(tap(seq))
        assert len(results) == 6
        # Still until the command, then 2 m/s at 6 m: 1.67 px a frame.
        step = 2.0 * 0.1 * FX / 6.0
        assert columns[0] == columns[1]
        assert np.diff(columns[1:]) == pytest.approx([step] * 4, abs=0.6)
        assert seq.state()["obj_pos"][0][0] >= 4 * 0.2
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/sim", b'{"yaw_rate": "fast"}')
        assert e.value.code == 400


TINY = ["--preset", "tiny", "--height", "64", "--width", "128", "--fx",
        "100"]


def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = trun.main(argv, device="cpu")
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith("{")]
    return rc, lines, err.getvalue()


def test_cli_interactive_source_with_the_dashboard():
    """--source interactive and --serve-port no longer exit 2; the
    dashboard is served during the run and closed when main returns."""
    rc, lines, err = _main(["--source", "interactive", "--frames", "3",
                            "--serve-port", "0", "--serve-host",
                            "127.0.0.1"] + TINY)
    assert rc == 0, err
    assert 1 <= len(lines) <= 3  # a live ring may drop a frame
    frames = [r["frame"] for r in lines]
    assert frames == sorted(frames) and frames[0] == 0
    assert all({"detections", "tracks", "valid", "ego"} <= set(r)
               for r in lines)
    port = int(re.search(r"live dashboard: http://127\.0\.0\.1:(\d+)/",
                         err)[1])
    assert "interactive sim" in err
    with pytest.raises(urllib.error.URLError):
        _get(f"http://127.0.0.1:{port}", "/status.json")
    rc, lines, _ = _main(["--source", "interactive", "--frames", "2"] + TINY)
    assert rc == 0 and 1 <= len(lines) <= 2


def test_cli_closes_the_dashboard_when_the_run_fails(monkeypatch):
    opened = []
    real = tdash.LiveDashboard

    class Kept(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            opened.append(self)

    def failing(*a, **kw):
        raise RuntimeError("the run failed")

    monkeypatch.setattr(tdash, "LiveDashboard", Kept)
    monkeypatch.setattr(PipelineRunner, "run", failing)
    with pytest.raises(RuntimeError, match="the run failed"):
        _main(["--source", "synthetic", "--frames", "2", "--serve-port",
               "0", "--serve-host", "127.0.0.1"] + TINY)
    assert len(opened) == 1
    with pytest.raises(urllib.error.URLError):
        _get(f"http://127.0.0.1:{opened[0].port}", "/status.json")
