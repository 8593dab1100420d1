"""Scene-flow construction (the JAX package's ``sceneflow.py``).

``SceneFlowConfig.gather_backend`` picks how the previous disparity is
looked up at the flow-matched pixel. ``"xla"``: a plain gather; the match
may lie any distance away, and a match outside the image is invalid.
``"pallas"``: the windowed gather (``ops/gather_cuda.py``); a match outside
the image or outside the covered window of ``match_v_radius`` x
``match_h_radius`` is invalid. ``"fused"``: the whole construct in one
kernel (``ops/sceneflow_cuda.py``) with the windowed semantics. ``"auto"``
is the windowed gather for CUDA tensors and the plain gather for CPU
tensors.

NaN marks invalid throughout. A pixel gets a velocity only if its whole
match chain validates; the velocity is (P_now - T P_prev) / dt where the
measured flow differs from the ego-motion flow by at least
``dynamic_flow_diff`` (or the disparity-rate test fires), else zero.
"""

from __future__ import annotations

import torch

from .ops import gather_cuda, geometry, resolve_backend, sceneflow_cuda
from .types import CameraModel, DisparityImage, SceneFlowCloud


def _nan_like(x):
    return torch.full_like(x, float("nan"))


def static_optical_flow(points_prev_transformed: torch.Tensor,
                        cam: CameraModel) -> torch.Tensor:
    """(H, W, 2) flow induced by ego-motion alone, NaN where the previous
    point is invalid."""
    h, w = points_prev_transformed.shape[:2]
    u, v = geometry.pixel_grid(h, w, points_prev_transformed.device)
    proj = geometry.project_points(points_prev_transformed, cam)
    flow = proj - torch.stack([u, v], dim=-1)
    invalid = torch.isnan(points_prev_transformed[..., 0])
    return torch.where(invalid[..., None], _nan_like(flow), flow)


def construct_scene_flow(points_now, points_prev_transformed, flow,
                         disparity_now: DisparityImage,
                         disparity_previous: DisparityImage,
                         cam: CameraModel, dt, dynamic_flow_diff,
                         transform_prev2now=None, config=None,
                         dynamic_disparity_rate=0.0):
    """Per-pixel velocity cloud: (SceneFlowCloud, static_flow). With the
    fused backend ``points_now`` and ``points_prev_transformed`` are not
    read (the kernel derives both from the disparities) and may be None."""
    dev = flow.device
    if transform_prev2now is None:
        transform_prev2now = torch.eye(4, dtype=torch.float32, device=dev)
    backend = resolve_backend(
        getattr(config, "gather_backend", "xla") if config else "xla", dev)
    if backend == "fused":
        params = sceneflow_cuda.pack_params(
            cam, disparity_now, disparity_previous, transform_prev2now, dt,
            dynamic_flow_diff, dynamic_disparity_rate)
        points, velocity, static_flow = sceneflow_cuda.scene_flow_fused_cuda(
            disparity_now.disparity, disparity_previous.disparity, flow,
            params, v_radius=config.match_v_radius,
            h_radius=config.match_h_radius)
        return SceneFlowCloud(points=points, velocity=velocity), static_flow

    h, w = points_now.shape[:2]
    u, v = geometry.pixel_grid(h, w, dev)
    static_flow = static_optical_flow(points_prev_transformed, cam)
    valid_now = torch.isfinite(points_now[..., 0])

    # Previous pixel = round(now - flow), the reference's backward lookup.
    flow_finite = torch.isfinite(flow[..., 0]) & torch.isfinite(flow[..., 1])
    safe_flow = torch.where(flow_finite[..., None], flow,
                            torch.zeros_like(flow))
    up = torch.round(u - safe_flow[..., 0]).to(torch.int32)
    vp = torch.round(v - safe_flow[..., 1]).to(torch.int32)

    d_now = disparity_now.disparity
    right_now_ok = disparity_now.valid_mask() & (d_now >= 0.0)
    if backend == "pallas":
        # NaN marks every miss (outside the image or the window), which
        # the isfinite gate below covers: no separate bounds mask.
        d_prev = gather_cuda.window_gather(
            disparity_previous.disparity, vp, up,
            v_radius=config.match_v_radius, h_radius=config.match_h_radius)
        prev_in_bounds = True
    else:
        d_prev, prev_in_bounds = geometry.gather_pixels(
            disparity_previous.disparity, up, vp)
    right_prev_ok = (prev_in_bounds & torch.isfinite(d_prev)
                     & (d_prev >= disparity_previous.min_disparity)
                     & (d_prev <= disparity_previous.max_disparity)
                     & (d_prev >= 0.0))
    match_ok = flow_finite & right_now_ok & right_prev_ok

    prev_point_ok = right_prev_ok & (d_prev != 0.0)
    safe_d = torch.where(prev_point_ok, d_prev, torch.ones_like(d_prev))
    z_prev = disparity_previous.f * disparity_previous.t / safe_d
    x_prev = (up.float() - cam.cx) / cam.fx * z_prev
    y_prev = (vp.float() - cam.cy) / cam.fy * z_prev
    prev_pts = geometry.transform_points(
        transform_prev2now, torch.stack([x_prev, y_prev, z_prev], dim=-1))

    static_ok = torch.isfinite(static_flow[..., 0])
    have_velocity = valid_now & match_ok & prev_point_ok & static_ok

    flow_diff = flow - static_flow
    diff_norm = torch.sqrt((flow_diff * flow_diff).sum(-1))
    is_dynamic = diff_norm >= dynamic_flow_diff

    vel = (points_now - prev_pts) / dt
    rate = torch.as_tensor(dynamic_disparity_rate, dtype=torch.float32,
                           device=dev)
    qz = prev_pts[..., 2]
    d_pred = torch.where(
        qz > 0.0,
        disparity_now.f * disparity_now.t / torch.clamp(qz, min=1e-6),
        _nan_like(qz))
    ddot = (d_now - d_pred).abs() / dt
    is_dynamic = is_dynamic | ((rate > 0.0) & (ddot >= rate))
    vel = torch.where(is_dynamic[..., None], vel, torch.zeros_like(vel))
    velocity = torch.where(have_velocity[..., None], vel, _nan_like(vel))
    points = torch.where(valid_now[..., None], points_now,
                         _nan_like(points_now))
    return SceneFlowCloud(points=points, velocity=velocity), static_flow
