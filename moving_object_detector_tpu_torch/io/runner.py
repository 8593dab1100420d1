"""Host streaming runner: sequence -> pipeline -> exported products (the
JAX package's ``io/runner.py``).

* a producer thread decodes or renders frames into the SPSC frame ring
  (``frame_ring.py``), the sensor-topic analog;
* the consumer loop uploads each frame from a pinned host buffer with a
  non-blocking copy and runs ``detect_step`` on it;
* the outputs of frame k - 1 are fetched after frame k has been enqueued,
  as one batch of copies (``types.to_host``), then optionally exported
  (marker JSON, label / flow / depth / velocity images) and shown on the
  live dashboard (``io/dashboard.py``), both from that host copy;
* the state left by a run can be snapshotted and a later run resumed
  from it;
* while a span recorder is active (``utils/profiling.py``), each pair
  ``k`` gets spans ``ring`` (its push to its pop), ``ring_pop``,
  ``dispatch``, ``pending`` (the end of its dispatch to the start of its
  harvest) and ``harvest`` of unit ``k``, and the run the counter
  ``ring_drops`` of the unit of its first pair; ``ring_drops`` of the
  runner holds the last run's count in any case.

The runner works on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without a device it raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import PipelineConfig
from ..tunables import Tunables
from ..types import StereoModel, to_host
from ..utils import profiling
from ..utils.profiling import StageTimer
from . import viz
from .frame_ring import FrameRing


@dataclasses.dataclass
class FrameResult:
    """Host-side distillation of one frame's outputs."""

    index: int
    time: float
    n_detections: int
    n_tracks: int
    detections: dict
    tracks: dict
    ego_success: bool
    frame_valid: bool
    # Capacity observability (pipeline.FrameOutput): size-passing clusters
    # dropped beyond max_objects / track bank full after this frame.
    cluster_overflow: int = 0
    tracker_saturated: bool = False
    # Wall-clock at harvest. When the stream timestamps are producer
    # wall-clock (live/socket sources), harvest_wall - time is the
    # end-to-end capture->published latency of this frame.
    harvest_wall: float = 0.0


class _RunToken:
    """Per-run() feeder handshake: lingering threads from a previous run
    hold a stale token and cannot affect the current run."""

    def __init__(self):
        self.stop = threading.Event()
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


# What the runner calls on a dashboard (io/dashboard.LiveDashboard).
_DASHBOARD_METHODS = ("wanted_fields", "update", "pop_pending_tunables",
                      "set_tunables_view")


class _Uploader:
    """Host frame -> device tensor. On a CUDA device the pair is staged in
    one of two pinned buffers and copied with ``non_blocking=True``; a
    buffer is reused only after the event recorded behind its last copy
    has passed."""

    def __init__(self, shape, device: torch.device):
        self.device = device
        self.slots = []
        self.turn = 0
        if device.type == "cuda":
            for _ in range(2):
                buf = torch.empty((2,) + tuple(shape), dtype=torch.float32,
                                  pin_memory=True)
                self.slots.append((buf, torch.cuda.Event()))

    def __call__(self, left: np.ndarray, right: np.ndarray):
        if not self.slots:
            return (torch.from_numpy(np.ascontiguousarray(left)),
                    torch.from_numpy(np.ascontiguousarray(right)))
        buf, event = self.slots[self.turn]
        self.turn = 1 - self.turn
        event.synchronize()  # a no-op until the event has been recorded
        buf[0].copy_(torch.from_numpy(np.ascontiguousarray(left)))
        buf[1].copy_(torch.from_numpy(np.ascontiguousarray(right)))
        pair = buf.to(self.device, non_blocking=True)
        event.record()
        return pair[0], pair[1]


class PipelineRunner:
    """Drives ``detect_step`` over a stereo sequence."""

    def __init__(
        self,
        config: PipelineConfig,
        stereo: StereoModel,
        flow_model=None,
        export_dir: Optional[str] = None,
        export_every: int = 1,
        ring_capacity: int = 4,
        drop_oldest: bool = False,
        reconfigure_file: Optional[str] = None,
        dashboard=None,
        device=None,
    ):
        if dashboard is not None and not all(
                hasattr(dashboard, m) for m in _DASHBOARD_METHODS):
            raise TypeError(f"dashboard {dashboard!r} lacks one of "
                            f"{_DASHBOARD_METHODS} (io/dashboard.py)")
        self.device = resolve_device(device)
        self.config = config
        self.stereo = stereo
        self.flow_model = flow_model
        self.export_dir = export_dir
        self.export_every = export_every
        color = getattr(config, "color", False)
        self.ring = FrameRing(
            config.height, config.width, capacity=ring_capacity,
            drop_oldest=drop_oldest, channels=3 if color else 1,
        )
        shape = (config.height, config.width) + ((3,) if color else ())
        self._upload = _Uploader(shape, self.device)
        self.timer = StageTimer()
        if export_dir:
            os.makedirs(export_dir, exist_ok=True)
        # Runtime reconfigure channels: a watched JSON file and the
        # dashboard's POST /tunables, whose keys are Tunables fields.
        # Applied between frames, their values ride into the next
        # ``detect_step`` as 0-d tensors; ``tunable_values`` mirrors them
        # on the host, so publishing them reads no tensor.
        self.tunables = Tunables.from_config(config, device=self.device)
        self.tunable_values = {
            k: Tunables.stored(k, v)
            for k, v in Tunables.config_values(config).items()}
        self.reconfigure_file = reconfigure_file
        # Live HTTP viewer (io/dashboard.LiveDashboard), fed from the
        # harvest's host copy with the rig's intrinsics on the host.
        self.dashboard = dashboard
        self._stereo_host = None if dashboard is None else to_host(stereo)
        self._reconfigure_mtime: float = -1.0
        self.final_state = None
        self.last_results: list[FrameResult] = []
        self.ring_drops = 0  # pairs the ring dropped in the last run

    def _maybe_reload_tunables(self) -> bool:
        """Between frames: if the reconfigure file changed, apply its
        values. Returns True when a reload was applied. Unknown keys and
        malformed JSON are reported and skipped (a live tuning UI must
        not be able to crash the pipeline)."""
        path = self.reconfigure_file
        if not path:
            return False
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return False  # not created yet
        if mtime == self._reconfigure_mtime:
            return False
        self._reconfigure_mtime = mtime
        try:
            with open(path) as f:
                values = json.load(f)
        except (OSError, ValueError) as e:
            print(f"# reconfigure: unreadable {path}: {e}", flush=True)
            return False
        known = {k: v for k, v in values.items()
                 if hasattr(self.tunables, k)}
        unknown = sorted(set(values) - set(known))
        if unknown:
            print(f"# reconfigure: ignoring unknown keys {unknown}",
                  flush=True)
        if not known:
            return False
        self._retune(known)
        print(f"# reconfigure: applied {known}", flush=True)
        return True

    def _retune(self, values: dict) -> None:
        """Apply known Tunables fields, on the device and in the mirror."""
        self.tunables = self.tunables.replace_values(**values)
        self.tunable_values.update(
            {k: Tunables.stored(k, v) for k, v in values.items()})

    def _apply_dashboard_tunables(self) -> bool:
        """Between frames: drain knob values POSTed to the dashboard's
        /tunables endpoint (the rqt-reconfigure loop: observe AND adjust
        in one pane) and publish the current values for /tunables.json
        from the host mirror. Same validation as the file channel: unknown
        keys are reported and skipped, never fatal."""
        if self.dashboard is None:
            return False
        values = self.dashboard.pop_pending_tunables()
        known = {k: v for k, v in values.items()
                 if hasattr(self.tunables, k)}
        unknown = sorted(set(values) - set(known))
        if unknown:
            print(f"# dashboard reconfigure: ignoring unknown keys "
                  f"{unknown}", flush=True)
        if known:
            self._retune(known)
            print(f"# dashboard reconfigure: applied {known}", flush=True)
        self.dashboard.set_tunables_view(self.tunable_values)
        return bool(known)

    def _feeder(self, sequence: Iterable, token: "_RunToken"):
        try:
            for left, right, t in sequence:
                if token.stop.is_set():
                    return
                # Blocking (backpressure) mode: keep retrying in short
                # slices so a slow consumer neither drops the frame nor
                # wedges the thread past a stop request.
                while not token.stop.is_set():
                    if self.ring.push(left, right, t, timeout=2.0):
                        break
        except Exception as e:  # surface decode errors to run()
            token.error = e
        finally:
            token.done.set()

    def run(
        self,
        sequence: Iterable,
        max_frames: Optional[int] = None,
        initial_state=None,
    ):
        """Run the pipeline over the sequence; returns list[FrameResult].

        ``initial_state``: resume from a PipelineState snapshot
        (``restore_state``) instead of a fresh state: a deterministic
        resume on recorded sequences. The final state of every run is
        kept in ``final_state`` for ``save_state``.
        """
        from ..pipeline import PipelineState, detect_step

        state = (
            initial_state
            if initial_state is not None
            else PipelineState.create(self.config, device=self.device)
        )
        self.final_state = state
        # Per-run token (not shared instance attrs): a lingering feeder
        # from a previous max_frames-truncated run can neither flip this
        # run's done flag nor interleave its frames (we join it + drain
        # the ring first).
        prev = getattr(self, "_feeder_thread", None)
        if prev is not None and prev.is_alive():
            self._token.stop.set()
            prev.join(timeout=10.0)
        while self.ring.pop(timeout=0.0) is not None:
            pass  # discard frames left over from a truncated previous run
        drops0 = self.ring.dropped()
        token = _RunToken()
        self._token = token
        feeder = threading.Thread(
            target=self._feeder, args=(sequence, token), daemon=True
        )
        self._feeder_thread = feeder
        feeder.start()

        results: list[FrameResult] = []
        pending = None  # (index, t, FrameOutput, left, dispatch end) behind
        # Frame numbering (and export filenames) continue across a resume.
        k0 = int(state.frame_index)
        k = k0
        try:
            while max_frames is None or k < k0 + max_frames:
                if token.done.is_set() and self.ring.size() == 0:
                    break  # the sequence has ended and is consumed
                with self.timer.stage("ring_pop", unit=k):
                    frame = self.ring.pop(timeout=0.25)
                if frame is None:
                    if token.done.is_set() and self.ring.size() == 0:
                        break
                    continue
                profiling.add("ring", self.ring.pushed_ns, unit=k)
                left, right, t = frame
                self._maybe_reload_tunables()
                self._apply_dashboard_tunables()
                with self.timer.stage("dispatch", unit=k):
                    left_d, right_d = self._upload(left, right)
                    state, out = detect_step(
                        self.flow_model, state, left_d, right_d, t,
                        self.stereo, self.config, tunables=self.tunables,
                    )
                # Harvest the previous frame after this one is enqueued.
                if pending is not None:
                    results.append(self._harvest(*pending))
                pending = (k, t, out, left, profiling.clock_ns())
                k += 1
            if pending is not None:
                results.append(self._harvest(*pending))
        finally:
            token.stop.set()
            # Leave no feeder behind: popping frees a slot, so a push that
            # waits for room returns and the thread sees the stop request.
            # A source that blocks on its own (a live directory waiting
            # for files) is given up on after a few seconds; the thread
            # is a daemon and holds a stale token.
            deadline = time.monotonic() + 5.0
            while feeder.is_alive() and time.monotonic() < deadline:
                self.ring.pop(timeout=0.0)
                feeder.join(timeout=0.05)
            # Inside finally: a crash/interrupt mid-run must still leave
            # the progress made so far snapshottable via save_state.
            self.final_state = state
            self.last_results = results
            self.ring_drops = self.ring.dropped() - drops0
            rec = profiling.active()
            if rec is not None:
                rec.count("ring_drops", self.ring_drops, unit=k0)
        if token.error is not None:
            raise RuntimeError(
                f"frame feeder failed after {len(results)} processed "
                f"frames (partial results in .last_results, state in "
                f".final_state)"
            ) from token.error
        return results

    def save_state(self, path: str) -> None:
        """Snapshot the state left by the last run() into one ``.npz``."""
        from ..utils.checkpoint import save_pipeline_state

        save_pipeline_state(path, self.final_state)

    def restore_state(self, path: str):
        """Load a snapshot produced by save_state onto the runner's
        device; pass to run(..., initial_state=...)."""
        from ..utils.checkpoint import restore_pipeline_state

        return restore_pipeline_state(path, device=self.device)

    def _harvest(self, index: int, t: float, out, left=None,
                 dispatched_ns: int = 0) -> FrameResult:
        export = bool(self.export_dir) and index % self.export_every == 0
        profiling.add("pending", dispatched_ns, unit=index)
        with self.timer.stage("harvest", unit=index):
            # One batch of copies of the fields read this frame: the
            # results' always, the exports' on an export frame, the
            # wanted dashboard products'.
            keep = {"detections", "tracked", "ego_success", "frame_valid",
                    "cluster_overflow", "tracker_saturated"}
            if export:
                keep |= {"label_image", "flow", "static_flow", "scene_flow"}
            if self.dashboard is not None:
                keep |= self.dashboard.wanted_fields()
            host = to_host(dataclasses.replace(out, **{
                f.name: None for f in dataclasses.fields(out)
                if f.name not in keep}))
            det = host.detections
            trk = host.tracked.objects
            result = FrameResult(
                index=index,
                time=t,
                n_detections=int(det.valid.sum()),
                n_tracks=int(trk.valid.sum()),
                detections={
                    "id": det.id[det.valid],
                    "center": det.center[det.valid],
                    "velocity": det.velocity[det.valid],
                    "bounding_box": det.bounding_box[det.valid],
                },
                tracks={
                    "id": trk.id[trk.valid],
                    "center": trk.center[trk.valid],
                    "velocity": trk.velocity[trk.valid],
                    "bounding_box": trk.bounding_box[trk.valid],
                    # 4x4 KF covariance per published track.
                    "covariance": host.tracked.covariance[trk.valid],
                },
                ego_success=bool(host.ego_success),
                frame_valid=bool(host.frame_valid),
                cluster_overflow=int(host.cluster_overflow),
                tracker_saturated=bool(host.tracker_saturated),
                harvest_wall=time.time(),
            )
            if result.cluster_overflow or result.tracker_saturated:
                print(
                    f"WARNING frame {index}: capacity saturated "
                    f"(clusters dropped={result.cluster_overflow}, "
                    f"track bank full={result.tracker_saturated}) — "
                    f"raise ClustererConfig.max_objects / "
                    f"TrackerConfig.max_tracks",
                    file=sys.stderr,
                )
        if export:
            with self.timer.stage("export", unit=index):
                self._export(index, host)
        if self.dashboard is not None:
            with self.timer.stage("dashboard", unit=index):
                self.dashboard.update(index, t, host, left, self.config,
                                      self._stereo_host)
        return result

    def _export(self, index: int, host) -> None:
        """Write the file products of one frame from its host copy."""
        prefix = os.path.join(self.export_dir, f"{index:06d}")
        viz.write_ppm(
            prefix + "_clusters.ppm",
            viz.colorize_labels(host.label_image,
                                self.config.clusterer.max_objects),
        )
        viz.write_ppm(prefix + "_flow.ppm", viz.flow_to_rgb(host.flow))
        viz.write_ppm(prefix + "_static_flow.ppm",
                      viz.flow_to_rgb(host.static_flow))
        viz.write_ppm(prefix + "_depth.ppm",
                      viz.depth_image(host.scene_flow.points))
        viz.write_ppm(
            prefix + "_velocity.ppm",
            viz.velocity_image(host.scene_flow.velocity,
                               self.config.scene_flow.max_color_velocity),
        )
        markers = viz.objects_to_markers(host.detections,
                                         color=(1, 0, 0, 0.8))
        markers += viz.objects_to_markers(
            host.tracked.objects, frame_id="odom", color=(0, 1, 0, 0.8)
        )
        viz.write_marker_json(prefix + "_markers.json", markers)

    def report(self) -> str:
        return self.timer.report()
