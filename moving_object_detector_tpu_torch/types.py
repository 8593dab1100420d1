"""Typed tensor "message" contracts (the JAX package's ``types.py``).

Frozen dataclasses of tensors in place of Flax ``struct`` classes: fixed
capacities with validity masks for object lists, NaN for invalid entries
in dense image-like products. ``replace`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import torch


def _f32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device or v.device, dtype=torch.float32)
    return torch.tensor(v, dtype=torch.float32, device=device)


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CameraModel(_Replace):
    """Pinhole intrinsics of a rectified camera (0-d f32 tensors)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def create(cls, fx, fy, cx, cy, device=None) -> "CameraModel":
        from . import resolve_device

        device = resolve_device(device)
        return cls(fx=_f32(fx, device), fy=_f32(fy, device),
                   cx=_f32(cx, device), cy=_f32(cy, device))


@dataclasses.dataclass(frozen=True)
class StereoModel(_Replace):
    """Rectified stereo rig: left intrinsics, baseline (m) and the static
    base_link <- camera extrinsic (identity: the camera is the base)."""

    cam: CameraModel
    baseline: torch.Tensor
    base_from_camera: torch.Tensor  # (4, 4)

    @classmethod
    def create(cls, fx, fy, cx, cy, baseline, base_from_camera=None,
               device=None) -> "StereoModel":
        from . import resolve_device

        device = resolve_device(device)
        if base_from_camera is None:
            base_from_camera = torch.eye(4, dtype=torch.float32)
        return cls(
            cam=CameraModel.create(fx, fy, cx, cy, device=device),
            baseline=_f32(baseline, device),
            base_from_camera=torch.as_tensor(
                base_from_camera, dtype=torch.float32).to(device),
        )


@dataclasses.dataclass(frozen=True)
class DisparityImage(_Replace):
    """Dense (H, W) f32 disparity with the matcher's focal length ``f``,
    baseline ``t`` and validity range."""

    disparity: torch.Tensor
    f: torch.Tensor
    t: torch.Tensor
    min_disparity: torch.Tensor
    max_disparity: torch.Tensor

    @classmethod
    def create(cls, disparity, f, t, min_disparity=0.0, max_disparity=128.0):
        disparity = torch.as_tensor(disparity, dtype=torch.float32)
        dev = disparity.device
        return cls(
            disparity=disparity,
            f=_f32(f, dev),
            t=_f32(t, dev),
            min_disparity=_f32(min_disparity, dev),
            max_disparity=_f32(max_disparity, dev),
        )

    def valid_mask(self) -> torch.Tensor:
        """Finite and within [min_disparity, max_disparity]."""
        d = self.disparity
        return (torch.isfinite(d) & (d >= self.min_disparity)
                & (d <= self.max_disparity))


@dataclasses.dataclass(frozen=True)
class SceneFlowCloud(_Replace):
    """Organized per-pixel (H, W, 3) points and velocities, NaN = invalid."""

    points: torch.Tensor
    velocity: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MovingObjects(_Replace):
    """Fixed-capacity object list; invalid rows carry zeros (id -1)."""

    id: torch.Tensor  # (K,) int32
    center: torch.Tensor  # (K, 3) f32
    velocity: torch.Tensor  # (K, 3) f32
    bounding_box: torch.Tensor  # (K, 3) f32
    valid: torch.Tensor  # (K,) bool

    @classmethod
    def empty(cls, capacity: int, device=None) -> "MovingObjects":
        z = lambda: torch.zeros((capacity, 3), dtype=torch.float32,
                                device=device)
        return cls(
            id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            center=z(), velocity=z(), bounding_box=z(),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.id.shape[0]


@dataclasses.dataclass(frozen=True)
class TrackedObjects(_Replace):
    """Published tracks plus their (K, 4, 4) covariances."""

    objects: MovingObjects
    covariance: torch.Tensor



def _map_tensors(node, fn):
    """``node`` with ``fn`` applied to every tensor in it; dataclasses,
    tuples, lists and dicts are walked, other leaves kept."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node)(**{f.name: _map_tensors(getattr(node, f.name), fn)
                             for f in dataclasses.fields(node)})
    if isinstance(node, (tuple, list)):
        return type(node)(_map_tensors(x, fn) for x in node)
    if isinstance(node, dict):
        return {k: _map_tensors(v, fn) for k, v in node.items()}
    return node


def to_host(tree):
    """``tree`` with every tensor as a numpy array, fetched as one batch:
    the copies from the card are queued together (``non_blocking``, into
    pinned memory) and waited for once per stream."""
    streams = {}

    def queue(t):
        t = t.detach()
        if t.device.type != "cuda":
            return t
        streams[t.device] = torch.cuda.current_stream(t.device)
        return t.to("cpu", non_blocking=True)

    staged = _map_tensors(tree, queue)
    for stream in streams.values():
        stream.synchronize()
    return _map_tensors(staged, lambda t: t.numpy())
