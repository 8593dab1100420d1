"""Pinhole / stereo geometry as dense tensor ops (the JAX package's
``ops/geometry.py``). NaN encodes invalid entries throughout."""

from __future__ import annotations

import torch

from ..types import CameraModel, DisparityImage


def pixel_grid(height: int, width: int, device=None):
    """(u, v) pixel-coordinate grids, each (H, W) f32."""
    u = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    return u.expand(height, width), v.expand(height, width)


def disparity_to_depth(disp: DisparityImage) -> torch.Tensor:
    """z = f * T / d, NaN where the disparity is invalid or zero."""
    d = disp.disparity
    valid = disp.valid_mask() & (d != 0.0)
    z = disp.f * disp.t / d
    return torch.where(valid, z, torch.full_like(z, float("nan")))


def disparity_to_points(disp: DisparityImage, cam: CameraModel):
    """Back-project a disparity image to an organized (H, W, 3) cloud."""
    h, w = disp.disparity.shape
    u, v = pixel_grid(h, w, disp.disparity.device)
    z = disparity_to_depth(disp)
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def project_points(points: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """(..., 3) -> (..., 2) pixel coords; z <= 0 projects to NaN."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    safe_z = torch.where(z <= 0.0, torch.full_like(z, float("nan")), z)
    u = cam.fx * x / safe_z + cam.cx
    v = cam.fy * y / safe_z + cam.cy
    return torch.stack([u, v], dim=-1)


def make_se3(rotation: torch.Tensor, translation: torch.Tensor):
    """4x4 homogeneous transform from (..., 3, 3) R and (..., 3) t."""
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.zeros(rotation.shape[:-2] + (1, 4), dtype=rotation.dtype,
                         device=rotation.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(transform: torch.Tensor) -> torch.Tensor:
    rot_t = transform[..., :3, :3].transpose(-1, -2)
    t = transform[..., :3, 3]
    return make_se3(rot_t, -(rot_t @ t[..., None])[..., 0])


def transform_points(transform: torch.Tensor, points: torch.Tensor):
    """Apply a 4x4 SE(3) transform to (..., 3) points (NaN stays NaN)."""
    return points @ transform[:3, :3].T + transform[:3, 3]


def rotate_vectors(transform: torch.Tensor, vectors: torch.Tensor):
    return vectors @ transform[:3, :3].T


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map, batched: (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.vector_norm(omega, dim=-1)
    small = theta < 1e-8
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    k = omega / safe_theta[..., None]
    z = torch.zeros_like(k[..., 0])
    kx = torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], z, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], z], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    s = torch.sin(theta)[..., None, None]
    c = (1.0 - torch.cos(theta))[..., None, None]
    rot = eye + s * kx + c * (kx @ kx)
    return torch.where(small[..., None, None], eye.expand_as(rot), rot)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [omega, t] -> (..., 4, 4), translation applied directly."""
    return make_se3(so3_exp(xi[..., :3]), xi[..., 3:])


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor):
    """Sample (H, W) or (H, W, C) ``image`` at (..., 2) (u, v) coords,
    bilinear, clamped to the border."""
    h, w = image.shape[:2]
    squeeze = image.dim() == 2
    img = image[..., None] if squeeze else image
    u = coords[..., 0].clamp(0.0, w - 1.0)
    v = coords[..., 1].clamp(0.0, h - 1.0)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    u0i = u0.long()
    v0i = v0.long()
    u1i = (u0i + 1).clamp(max=w - 1)
    v1i = (v0i + 1).clamp(max=h - 1)
    p00 = img[v0i, u0i]
    p01 = img[v0i, u1i]
    p10 = img[v1i, u0i]
    p11 = img[v1i, u1i]
    out = (p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv)
           + p10 * (1 - du) * dv + p11 * du * dv)
    return out[..., 0] if squeeze else out


def gather_pixels(image: torch.Tensor, u_idx: torch.Tensor,
                  v_idx: torch.Tensor):
    """Integer gather at (v, u) plus an in-bounds mask; out-of-bounds
    values come from clamped indices and must be masked by the caller."""
    h, w = image.shape[:2]
    in_bounds = (u_idx >= 0) & (u_idx < w) & (v_idx >= 0) & (v_idx < h)
    uc = u_idx.clamp(0, w - 1).long()
    vc = v_idx.clamp(0, h - 1).long()
    return image[vc, uc], in_bounds
