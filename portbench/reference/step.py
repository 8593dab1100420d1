"""Frozen copy of ``moving_object_detector_tpu_torch/pipeline.py`` (the
stages of detect_step) at fc97bde (``run_frame`` added), the benchmark's
plain reference: it imports nothing of the port.

One frame's stages, each from the inputs the serving step gives it:
the pieces of the serving step (``pipeline.detect_step``) that turn a
stereo pair and the previous frame's state into disparity, flow,
ego-motion, scene flow, detections and tracks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import geometry
from .resize import resize_image
from .sgm import compute_disparity, disparity_with_metadata, sgm_disparity_raw
from .types import DisparityImage, MovingObjects, StereoModel
from .config import PipelineConfig


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


def _flow_forward(flow_model, prev_img, now_img, input_scale: int = 1):
    """Run the flow net on edge-padded inputs: (H, W, 2) flow."""
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
        full, _ = flow_model(prep(prev_img), prep(now_img))
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


def run_frame(net, prev: dict, left, right, t, stereo: StereoModel,
              config: PipelineConfig, given: dict | None = None,
              own_motion: bool = False, own: dict | None = None):
    """One frame, stage by stage: (outputs, next state).

    ``prev`` holds the state a frame starts from: ``pose`` (4, 4),
    ``prev_left``, ``prev_disparity`` (a ``DisparityImage``),
    ``prev_time``, ``has_prev`` (host bool), ``tracker`` (a
    ``TrackerState``) and ``frame_index`` (host int). ``outputs`` holds
    each stage's own result: ``disparity``, ``flow``, ``motion``,
    ``ego_success``, ``scene_flow``, ``static_flow``, ``detections``,
    ``label_image``, ``cluster_overflow``, ``odom_pose``, ``tracked``.
    ``given`` maps some of those names to values that the later stages
    take in place of this function's own: judging a program stage by
    stage, each stage starts from what the program's earlier stages gave.
    ``own`` holds this function's own ``disparity`` and ``flow`` of the
    same frame from an earlier call, not computed again.
    """
    from .clusterer import cluster_scene_flow
    from .egomotion import estimate_motion
    from .sceneflow import construct_scene_flow
    from .tracker import track_step
    from .tunables import Tunables
    from .types import SceneFlowCloud, TrackedObjects

    given = given or {}
    dev = left.device
    cam = stereo.cam
    tun = Tunables.from_config(config, device=dev)
    gray_left, gray_right = luma(left), luma(right)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    out = {}

    out["disparity"] = (own["disparity"] if own else
                        _sgm_forward(gray_left, gray_right, stereo, config))
    disparity_now = given.get("disparity", out["disparity"])
    disparity_prev = prev["prev_disparity"]

    out["flow"] = (own["flow"] if own else
                   _flow_forward(net, prev["prev_left"], left,
                                 input_scale=config.flow_input_scale))
    flow = given.get("flow", out["flow"])

    def ego(flow):
        return estimate_motion(
            luma(prev["prev_left"]), gray_left, disparity_prev, cam,
            ransac_generator(prev["frame_index"], dev), config.egomotion,
            dense_flow=flow if config.egomotion.use_dense_flow else None)

    motion, ego_ok, _ = ego(flow)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    if own_motion:
        from .egomotion import motion_score

        m_own, ok_own, _ = ego(out["flow"])
        out["motion_own"] = torch.where(ok_own & prev["has_prev"], m_own, eye)
        out["score"] = lambda m: float(motion_score(
            luma(prev["prev_left"]), disparity_prev, cam, out["flow"], m,
            config.egomotion))
    ego_ok = ego_ok & prev["has_prev"]
    out["motion"] = torch.where(ego_ok, motion, eye)
    out["ego_success"] = ego_ok
    motion = given.get("motion", out["motion"])
    ego_ok = given.get("ego_success", ego_ok)

    points_now = geometry.disparity_to_points(disparity_now, cam)
    points_prev = geometry.disparity_to_points(disparity_prev, cam)
    points_prev_tf = geometry.transform_points(motion, points_prev)
    dt = torch.clamp(t - prev["prev_time"], min=1e-3)
    cloud, static_flow = construct_scene_flow(
        points_now, points_prev_tf, flow, disparity_now, disparity_prev,
        cam, dt, tun.dynamic_flow_diff, transform_prev2now=motion,
        config=config.scene_flow,
        dynamic_disparity_rate=tun.dynamic_disparity_rate)
    frame_valid = ego_ok & prev["has_prev"]
    velocity = torch.where(frame_valid, cloud.velocity,
                           torch.full_like(cloud.velocity, float("nan")))
    out["scene_flow"] = SceneFlowCloud(points=cloud.points, velocity=velocity)
    out["static_flow"] = static_flow
    cloud = given.get("scene_flow", out["scene_flow"])

    detections, label_image, overflow = cluster_scene_flow(
        cloud, config.clusterer, return_overflow=True,
        dynamic_speed=tun.dynamic_speed, depth_diff=tun.depth_diff,
        cluster_size=tun.cluster_size,
        neighbor_distance=tun.neighbor_distance)
    out["detections"] = detections
    out["label_image"] = label_image
    out["cluster_overflow"] = overflow
    detections = given.get("detections", detections)

    t_bc = stereo.base_from_camera
    motion_base = t_bc @ motion @ geometry.se3_inverse(t_bc)
    new_pose = torch.where(ego_ok, prev["pose"] @ geometry.se3_inverse(
        motion_base), prev["pose"])
    cam_to_odom = new_pose @ t_bc
    out["odom_pose"] = cam_to_odom
    det_odom = transform_objects(detections, cam_to_odom)
    if bool(frame_valid):
        tracker, tracked = track_step(
            prev["tracker"], t, det_odom, config.tracker,
            object_radius=tun.object_radius,
            covariance_trace_limit=tun.covariance_trace_limit,
            correction_count_limit=tun.correction_count_limit)
    else:
        k = config.tracker.max_tracks
        tracker = prev["tracker"]
        tracked = TrackedObjects(
            objects=MovingObjects.empty(k, dev),
            covariance=torch.zeros((k, 4, 4), dtype=torch.float32,
                                   device=dev))
    out["tracked"] = tracked
    nxt = dict(pose=new_pose, prev_left=left, prev_disparity=disparity_now,
               prev_time=t, has_prev=True, tracker=tracker,
               frame_index=prev["frame_index"] + 1)
    return out, nxt
