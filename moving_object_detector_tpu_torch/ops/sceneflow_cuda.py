"""The fused scene-flow construct: wrapper of ``csrc/sceneflow_fused.cu``,
its plain version and the parameter vector both read.

Replaces the JAX package's Pallas kernel ``scene_flow_fused_pallas``
(``ops/sceneflow_pallas.py``): back-projection of both disparities,
static flow, windowed gather of the previous disparity at the
flow-matched pixel, the validity chain, the dynamic test and the velocity
in one pass. For CUDA tensors the wrapper launches the kernel and adds
one to ``LAUNCHES["sceneflow_fused"]``; for CPU tensors it runs the plain
version ``scene_flow_fused``, which repeats the kernel's arithmetic in the
same order. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import geometry

# Layout of the (27,) f32 parameter vector.
CAM_FX, CAM_FY, CAM_CX, CAM_CY = 0, 1, 2, 3
NOW_F, NOW_T, NOW_MIN, NOW_MAX = 4, 5, 6, 7
PRV_F, PRV_T, PRV_MIN, PRV_MAX = 8, 9, 10, 11
T00 = 12  # 12..23: rows of T_prev2now (r00 r01 r02 tx / r10.. ty / r20.. tz)
DT, DYN, VZ = 24, 25, 26
NPAR = 27

LAUNCHES = {"sceneflow_fused": 0}
_typed = False


def pack_params(cam, disparity_now, disparity_prev, transform_prev2now, dt,
                dynamic_flow_diff, dynamic_disparity_rate=0.0):
    """The kernel's (27,) f32 parameter vector, built on the device of
    the disparity (no fetch)."""
    dev = disparity_now.disparity.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1)

    head = [cam.fx, cam.fy, cam.cx, cam.cy,
            disparity_now.f, disparity_now.t,
            disparity_now.min_disparity, disparity_now.max_disparity,
            disparity_prev.f, disparity_prev.t,
            disparity_prev.min_disparity, disparity_prev.max_disparity]
    t = torch.as_tensor(transform_prev2now, dtype=torch.float32, device=dev)
    tail = [dt, dynamic_flow_diff, dynamic_disparity_rate]
    params = torch.cat([f32(x) for x in head] + [t[:3].reshape(12)]
                       + [f32(x) for x in tail])
    assert params.shape[0] == NPAR
    return params


def scene_flow_fused(d_now, d_prev, flow, params, v_radius: int = 16,
                     h_radius: int = 128):
    """Plain version: (points (H, W, 3), velocity (H, W, 3), static flow
    (H, W, 2)) from the two (H, W) disparities, the (H, W, 2) flow and the
    parameter vector. NaN marks invalid everywhere; a match outside the
    covered window (``geometry.window_gather``) gives no velocity."""
    h, w = d_now.shape
    dev = d_now.device
    p = lambda k: params[k]
    cfx, cfy, ccx, ccy = p(CAM_FX), p(CAM_FY), p(CAM_CX), p(CAM_CY)
    r = [p(T00 + k) for k in range(12)]
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    u, v = geometry.pixel_grid(h, w, dev)

    def backproject(d, f, t, dmin, dmax, uu, vv):
        valid = torch.isfinite(d) & (d >= dmin) & (d <= dmax) & (d != 0.0)
        z = torch.where(valid, f * t / d, nan)
        return (uu - ccx) / cfx * z, (vv - ccy) / cfy * z, z

    def transform(x, y, z):
        return (r[0] * x + r[1] * y + r[2] * z + r[3],
                r[4] * x + r[5] * y + r[6] * z + r[7],
                r[8] * x + r[9] * y + r[10] * z + r[11])

    pnx, pny, pnz = backproject(d_now, p(NOW_F), p(NOW_T), p(NOW_MIN),
                                p(NOW_MAX), u, v)
    valid_now = torch.isfinite(pnx)

    pox, poy, poz = backproject(d_prev, p(PRV_F), p(PRV_T), p(PRV_MIN),
                                p(PRV_MAX), u, v)
    ptx, pty, ptz = transform(pox, poy, poz)
    safe_z = torch.where(ptz <= 0.0, nan, ptz)
    static_x = (cfx * ptx / safe_z + ccx) - u
    static_y = (cfy * pty / safe_z + ccy) - v
    static_ok = torch.isfinite(static_x)

    fxv, fyv = flow[..., 0], flow[..., 1]
    flow_finite = torch.isfinite(fxv) & torch.isfinite(fyv)
    sfx = torch.where(flow_finite, fxv, zero)
    sfy = torch.where(flow_finite, fyv, zero)
    up = torch.round(u - sfx).to(torch.int32)
    vp = torch.round(v - sfy).to(torch.int32)
    d_prev_m = geometry.window_gather(d_prev, vp, up, v_radius, h_radius)

    right_now_ok = (torch.isfinite(d_now) & (d_now >= p(NOW_MIN))
                    & (d_now <= p(NOW_MAX)) & (d_now >= 0.0))
    right_prev_ok = (torch.isfinite(d_prev_m) & (d_prev_m >= p(PRV_MIN))
                     & (d_prev_m <= p(PRV_MAX)) & (d_prev_m >= 0.0))
    match_ok = flow_finite & right_now_ok & right_prev_ok
    prev_point_ok = right_prev_ok & (d_prev_m != 0.0)
    safe_d = torch.where(prev_point_ok, d_prev_m, torch.ones_like(d_prev_m))
    z_prev = p(PRV_F) * p(PRV_T) / safe_d
    x_prev = (up.float() - ccx) / cfx * z_prev
    y_prev = (vp.float() - ccy) / cfy * z_prev
    qx, qy, qz = transform(x_prev, y_prev, z_prev)
    have_velocity = valid_now & match_ok & prev_point_ok & static_ok

    fdx = fxv - static_x
    fdy = fyv - static_y
    diff_norm = torch.sqrt(fdx * fdx + fdy * fdy)
    is_dynamic = diff_norm >= p(DYN)
    dt = p(DT)
    d_pred = torch.where(qz > 0.0,
                         p(NOW_F) * p(NOW_T) / torch.clamp(qz, min=1e-6), nan)
    ddot = (d_now - d_pred).abs() / dt
    is_dynamic = is_dynamic | ((p(VZ) > 0.0) & (ddot >= p(VZ)))
    vel = [torch.where(have_velocity,
                       torch.where(is_dynamic, (a - b) / dt, zero), nan)
           for a, b in ((pnx, qx), (pny, qy), (pnz, qz))]
    return (torch.stack([pnx, pny, pnz], dim=-1), torch.stack(vel, dim=-1),
            torch.stack([static_x, static_y], dim=-1))


def _lib():
    global _typed
    lib = _build.load("sceneflow_fused")
    if not _typed:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.scene_flow_fused.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
        lib.scene_flow_fused.restype = I
        _typed = True
    return lib


def scene_flow_fused_cuda(d_now, d_prev, flow, params, v_radius: int = 16,
                          h_radius: int = 128):
    """``scene_flow_fused`` through the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if d_now.device.type == "cpu":
        return scene_flow_fused(d_now, d_prev, flow, params, v_radius,
                                h_radius)
    dev = d_now.device
    if dev.type != "cuda" or any(x.device != dev
                                 for x in (d_prev, flow, params)):
        raise ValueError("fused scene-flow inputs must be CUDA tensors on "
                         "one device")
    if any(x.dtype != torch.float32 for x in (d_now, d_prev, flow, params)):
        raise TypeError("the fused scene-flow kernel takes f32 inputs")
    h, w = d_now.shape[-2:]
    if (d_now.dim() != 2 or d_prev.shape != d_now.shape
            or tuple(flow.shape) != (h, w, 2)):
        raise ValueError(f"shapes {tuple(d_now.shape)} / "
                         f"{tuple(d_prev.shape)} / {tuple(flow.shape)} must "
                         "be (H, W) / (H, W) / (H, W, 2)")
    if tuple(params.shape) != (NPAR,):
        raise ValueError(f"params must be ({NPAR},), see pack_params")
    if v_radius < 0 or h_radius < 0:
        raise ValueError("the window radii must not be negative")
    d_now, d_prev, flow, params = (x.contiguous() for x in
                                   (d_now, d_prev, flow, params))
    rg, rt = geometry.window_spans(v_radius, h_radius)
    points = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    velocity = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    static_flow = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
    rc = _lib().scene_flow_fused(
        d_now.data_ptr(), d_prev.data_ptr(), flow.data_ptr(),
        params.data_ptr(), points.data_ptr(), velocity.data_ptr(),
        static_flow.data_ptr(), h, w, rg, rt,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "scene_flow_fused")
    LAUNCHES["sceneflow_fused"] += 1
    return points, velocity, static_flow
