"""The per-frame detection program (the JAX package's ``pipeline.py``).

    detect_step(flow_model, state, left, right, t, stereo, config)
        -> (state', FrameOutput)

SGM disparity, PWC-Net flow, dense-flow ego-motion, scene flow,
clustering and Kalman tracking for one stereo pair. PyTorch runs eagerly;
the JAX ``lax.cond``s become Python branches on flags fetched from the
device. The state lives on the device of ``PipelineState.create``, which
is ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.nn.functional as F

from . import resolve_device
from .clusterer import cluster_scene_flow
from .config import PipelineConfig
from .egomotion import estimate_motion
from .ops import geometry
from .ops.resize import resize_image
from .ops.sgm import compute_disparity, disparity_with_metadata, \
    sgm_disparity_raw
from .sceneflow import construct_scene_flow
from .tracker import TrackerState, track_step
from .tunables import Tunables
from .types import (DisparityImage, MovingObjects, SceneFlowCloud,
                    StereoModel, TrackedObjects)


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """Everything carried from one frame to the next. ``has_prev`` and
    ``frame_index`` are host values (they steer Python branches and seed
    the RANSAC generator)."""

    pose: torch.Tensor  # (4, 4) odom <- base_link
    prev_left: torch.Tensor  # (H, W[, 3]) f32
    prev_disparity: DisparityImage
    prev_time: torch.Tensor  # () f32
    has_prev: bool
    tracker: TrackerState
    frame_index: int

    @classmethod
    def create(cls, config: PipelineConfig, device=None) -> "PipelineState":
        dev = resolve_device(device)
        h, w = config.height, config.width
        shape = (h, w, 3) if getattr(config, "color", False) else (h, w)
        return cls(
            pose=torch.eye(4, dtype=torch.float32, device=dev),
            prev_left=torch.zeros(shape, dtype=torch.float32, device=dev),
            # max < min gates everything invalid until the first frame.
            prev_disparity=DisparityImage.create(
                torch.full((h, w), -1.0, dtype=torch.float32, device=dev),
                f=1.0, t=1.0, min_disparity=0.0, max_disparity=-1.0),
            prev_time=torch.zeros((), dtype=torch.float32, device=dev),
            has_prev=False,
            tracker=TrackerState.create(config.tracker.max_tracks, dev),
            frame_index=0,
        )

    @property
    def device(self) -> torch.device:
        return self.pose.device


@dataclasses.dataclass(frozen=True)
class FrameOutput:
    disparity: DisparityImage
    flow: torch.Tensor  # (H, W, 2)
    scene_flow: SceneFlowCloud
    static_flow: torch.Tensor  # (H, W, 2)
    detections: MovingObjects  # camera frame
    label_image: torch.Tensor  # (H, W) int32
    tracked: TrackedObjects  # odom frame
    motion: torch.Tensor  # (4, 4) p_now = M @ p_prev
    odom_pose: torch.Tensor  # (4, 4) odom <- camera
    ego_success: torch.Tensor  # () bool
    frame_valid: torch.Tensor  # () bool
    cluster_overflow: torch.Tensor  # () int32
    tracker_saturated: torch.Tensor  # () bool


def luma(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB -> (H, W) BT.601 luma; (H, W) passes through."""
    if img.dim() == 2:
        return img
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).to(img.dtype)


def _adapt_flow_channels(img: torch.Tensor, c: int) -> torch.Tensor:
    """(H, W[, C_in]) -> (H, W, c) for the flow weights' input width."""
    if img.dim() == 2:
        img = img[..., None]
    if img.shape[-1] == c:
        return img
    if c == 1:
        return luma(img)[..., None]
    if img.shape[-1] == 1:
        return img.expand(img.shape[:2] + (c,))
    raise ValueError(f"cannot adapt {tuple(img.shape)} to {c} flow channels")


def _nearest_up(x: torch.Tensor, s: int, out_hw) -> torch.Tensor:
    """Repeat each pixel s x s; trailing rows/cols replicate the edge."""
    h0, w0 = out_hw
    up = x.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)
    ph, pw = h0 - up.shape[0], w0 - up.shape[1]
    if ph or pw:
        up = torch.cat([up, up[-1:].expand((ph,) + up.shape[1:])], dim=0)
        up = torch.cat([up, up[:, -1:].expand(
            (up.shape[0], pw) + up.shape[2:])], dim=1)
    return up


def _window_minmax(x: torch.Tensor, fill: float, mode: str):
    """3x3 min or max over (H, W[, C]) with ``fill`` outside (the
    reduce_window "SAME" of the JAX code)."""
    xc = x if x.dim() == 3 else x[..., None]
    t = xc.permute(2, 0, 1)[None]
    if mode == "max":
        out = F.max_pool2d(F.pad(t, (1, 1, 1, 1), value=fill), 3, stride=1)
    else:
        out = -F.max_pool2d(F.pad(-t, (1, 1, 1, 1), value=-fill), 3,
                            stride=1)
    out = out[0].permute(1, 2, 0)
    return out if x.dim() == 3 else out[..., 0]


def edge_aware_flow_upsample(flow_s, out_hw, scale: int,
                             smooth_spread_px: float = 1.0):
    """Upsample a 1/``scale`` flow field to ``out_hw`` (vectors times
    scale): nearest everywhere, bilinear only where the 3x3 half-res
    spread is <= ``smooth_spread_px`` in both components, so no velocity
    is invented across a motion boundary."""
    s = int(scale)
    up_n = _nearest_up(flow_s, s, out_hw)
    up_b = resize_image(flow_s, out_hw)
    lo = _window_minmax(flow_s, float("inf"), "min")
    hi = _window_minmax(flow_s, float("-inf"), "max")
    spread = (hi - lo).amax(dim=-1)
    smooth = _nearest_up((spread <= smooth_spread_px)[..., None], s, out_hw)
    return torch.where(smooth, up_b, up_n) * float(scale)


def _flow_forward(flow_model, prev_img, now_img, input_scale: int = 1,
                  corr_backend: str | None = None):
    """Run the flow net on edge-padded inputs: (H, W, 2) flow.
    ``corr_backend`` overrides the net's own ``config.corr_backend``."""
    c = getattr(flow_model.config, "in_channels", 1)
    prev_img = _adapt_flow_channels(prev_img, c)
    now_img = _adapt_flow_channels(now_img, c)
    h0, w0 = prev_img.shape[:2]
    if input_scale > 1:
        hs, ws = h0 // input_scale, w0 // input_scale
        prev_img = resize_image(prev_img, (hs, ws))
        now_img = resize_image(now_img, (hs, ws))
    mult = 2 ** len(flow_model.config.feature_channels)
    h, w = prev_img.shape[:2]
    ph, pw = (-h) % mult, (-w) % mult

    def prep(img):
        x = img.permute(2, 0, 1)[None]
        return F.pad(x, (0, pw, 0, ph), mode="replicate") if ph or pw else x

    with torch.no_grad():
        full, _ = flow_model(prep(prev_img), prep(now_img),
                             corr_backend=corr_backend)
    flow = full[0, :, :h, :w].permute(1, 2, 0)
    if input_scale > 1:
        flow = edge_aware_flow_upsample(flow, (h0, w0), input_scale)
    return flow


def _sgm_forward(left, right, stereo: StereoModel,
                 config: PipelineConfig) -> DisparityImage:
    """SGM at 1/``sgm_input_scale`` resolution restored to full size:
    nearest upsample with disparities times the scale (-1 survives
    exactly), valid-weighted bilinear on smooth fully valid surfaces."""
    s = config.sgm_input_scale
    if s <= 1:
        return compute_disparity(left, right, stereo, config.sgm)
    h0, w0 = left.shape
    hs, ws = h0 // s, w0 // s
    disp_s = sgm_disparity_raw(resize_image(left, (hs, ws)),
                               resize_image(right, (hs, ws)), config.sgm)
    valid = disp_s >= 0
    neg1 = torch.full_like(disp_s, -1.0)
    disp_s = torch.where(valid, disp_s * float(s), neg1)
    disp = _nearest_up(disp_s, s, (h0, w0))

    vf = valid.float()
    zero = torch.zeros_like(disp_s)
    num = resize_image(torch.where(valid, disp_s, zero) * vf, (h0, w0))
    den = resize_image(vf, (h0, w0))
    bilin = num / torch.clamp(den, min=1e-6)
    inf = float("inf")
    lo = _window_minmax(torch.where(valid, disp_s, torch.full_like(zero, inf)),
                        inf, "min")
    hi = _window_minmax(
        torch.where(valid, disp_s, torch.full_like(zero, -inf)), -inf, "max")
    all_ok = -F.max_pool2d(-F.pad(vf[None, None], (1, 1, 1, 1), value=0.0),
                           3, stride=1)[0, 0]
    smooth_s = (all_ok > 0.5) & ((hi - lo) <= float(s))
    smooth = _nearest_up(smooth_s, s, (h0, w0))
    disp = torch.where(smooth & (disp >= 0), bilin, disp)
    meta = disparity_with_metadata(disp, stereo, config.sgm)
    return meta.replace(max_disparity=meta.max_disparity * float(s))


def transform_objects(objects: MovingObjects, tf) -> MovingObjects:
    """Camera -> odom: centers as points, velocities as vectors."""
    return objects.replace(
        center=geometry.transform_points(tf, objects.center),
        velocity=geometry.rotate_vectors(tf, objects.velocity))


def ransac_generator(frame_index: int, device) -> torch.Generator:
    """The RANSAC draw of frame ``frame_index``, seeded from (7, index)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((7 << 32) + int(frame_index))
    return gen


@contextlib.contextmanager
def _stage(stage_ms, name: str, device):
    """Add the wall ms of the enclosed stage to ``stage_ms[name]``,
    synchronizing the device before and after; a no-op without a dict."""
    if stage_ms is None:
        yield
        return
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    stage_ms[name] = stage_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def detect_step(flow_model, state: PipelineState, left, right, t,
                stereo: StereoModel, config: PipelineConfig,
                flow_override=None, disparity_override=None, tunables=None,
                stage_ms=None):
    """One frame: stereo pair -> disparity, flow, ego-motion, scene flow,
    detections, tracks. Returns (new_state, FrameOutput).

    ``flow_model`` is a ``PWCNet`` (unused with ``flow_override``); its
    correlation runs on ``config.flownet.corr_backend``, whatever the net
    was built with;
    ``flow_override`` (H, W, 2) / ``disparity_override`` swap in external
    perception results. A ``stage_ms`` dict receives the per-stage wall
    ms (sgm, flow, egomotion, scene_flow, clusterer, tracker), with a
    device synchronization around each stage; leave it None when timing
    the whole step."""
    dev = state.device
    cam = stereo.cam
    left = torch.as_tensor(left, device=dev).float()
    right = torch.as_tensor(right, device=dev).float()
    gray_left, gray_right = luma(left), luma(right)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    if tunables is None:
        tunables = Tunables.from_config(config, device=dev)

    with _stage(stage_ms, "sgm", dev):
        if disparity_override is not None:
            disparity_now = disparity_override
        else:
            disparity_now = _sgm_forward(gray_left, gray_right, stereo,
                                         config)
    disparity_prev = state.prev_disparity

    with _stage(stage_ms, "flow", dev):
        if flow_override is not None:
            flow = torch.as_tensor(flow_override, device=dev).float()
        else:
            flow = _flow_forward(flow_model, state.prev_left, left,
                                 input_scale=config.flow_input_scale,
                                 corr_backend=config.flownet.corr_backend)

    with _stage(stage_ms, "egomotion", dev):
        motion, ego_ok, _ = estimate_motion(
            luma(state.prev_left), gray_left, disparity_prev, cam,
            ransac_generator(state.frame_index, dev), config.egomotion,
            dense_flow=flow if config.egomotion.use_dense_flow else None)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    ego_ok = ego_ok & state.has_prev
    motion = torch.where(ego_ok, motion, eye)

    with _stage(stage_ms, "scene_flow", dev):
        points_now = geometry.disparity_to_points(disparity_now, cam)
        points_prev = geometry.disparity_to_points(disparity_prev, cam)
        points_prev_tf = geometry.transform_points(motion, points_prev)
        dt = torch.clamp(t - state.prev_time, min=1e-3)
        cloud, static_flow = construct_scene_flow(
            points_now, points_prev_tf, flow, disparity_now, disparity_prev,
            cam, dt, tunables.dynamic_flow_diff, transform_prev2now=motion,
            config=config.scene_flow,
            dynamic_disparity_rate=tunables.dynamic_disparity_rate)
        frame_valid = ego_ok & state.has_prev
        velocity = torch.where(frame_valid, cloud.velocity,
                               torch.full_like(cloud.velocity, float("nan")))
        cloud = SceneFlowCloud(points=cloud.points, velocity=velocity)

    with _stage(stage_ms, "clusterer", dev):
        detections, label_image, cluster_overflow = cluster_scene_flow(
            cloud, config.clusterer, return_overflow=True,
            dynamic_speed=tunables.dynamic_speed,
            depth_diff=tunables.depth_diff,
            cluster_size=tunables.cluster_size,
            neighbor_distance=tunables.neighbor_distance)

    t_bc = stereo.base_from_camera
    motion_base = t_bc @ motion @ geometry.se3_inverse(t_bc)
    new_pose = torch.where(ego_ok, state.pose @ geometry.se3_inverse(
        motion_base), state.pose)
    cam_to_odom = new_pose @ t_bc
    det_odom = transform_objects(detections, cam_to_odom)

    with _stage(stage_ms, "tracker", dev):
        if bool(frame_valid):
            new_tracker, tracked = track_step(
                state.tracker, t, det_odom, config.tracker,
                object_radius=tunables.object_radius,
                covariance_trace_limit=tunables.covariance_trace_limit,
                correction_count_limit=tunables.correction_count_limit)
        else:
            k = config.tracker.max_tracks
            new_tracker = state.tracker
            tracked = TrackedObjects(
                objects=MovingObjects.empty(k, dev),
                covariance=torch.zeros((k, 4, 4), dtype=torch.float32,
                                       device=dev))

    new_state = PipelineState(
        pose=new_pose, prev_left=left, prev_disparity=disparity_now,
        prev_time=t, has_prev=True, tracker=new_tracker,
        frame_index=state.frame_index + 1)
    output = FrameOutput(
        disparity=disparity_now, flow=flow, scene_flow=cloud,
        static_flow=static_flow, detections=detections,
        label_image=label_image, tracked=tracked, motion=motion,
        odom_pose=cam_to_odom, ego_success=ego_ok, frame_valid=frame_valid,
        cluster_overflow=cluster_overflow,
        tracker_saturated=new_tracker.active.all())
    return new_state, output
