"""Image-space preprocessing (the JAX package's ``ops/image.py``): center
crop with the intrinsics fix-up.

Crops a camera stream to a target size about the image center and shifts
the principal point by the crop offset, so the geometry downstream stays
consistent. Images may be tensors or numpy arrays (plain slicing).
"""

from __future__ import annotations

from ..types import CameraModel, StereoModel


def center_crop_offsets(height: int, width: int, target_h: int,
                        target_w: int):
    """Top-left corner of the centered crop (the offset is floored)."""
    if target_h > height or target_w > width:
        raise ValueError(f"crop {target_h}x{target_w} exceeds the image "
                         f"{height}x{width}")
    return (height - target_h) // 2, (width - target_w) // 2


def center_crop(image, cam: CameraModel, target_h: int, target_w: int):
    """Crop (H, W[, C]) to (target_h, target_w) about the center; returns
    the cropped image and intrinsics with cx, cy shifted by the crop
    offset (focal lengths unchanged)."""
    h, w = image.shape[:2]
    y0, x0 = center_crop_offsets(h, w, target_h, target_w)
    cropped = image[y0:y0 + target_h, x0:x0 + target_w]
    return cropped, CameraModel(fx=cam.fx, fy=cam.fy, cx=cam.cx - x0,
                                cy=cam.cy - y0)


def center_crop_stereo(left, right, stereo: StereoModel, target_h: int,
                       target_w: int):
    """Crop both images of a rectified pair identically (the same offsets
    keep the epipolar alignment and the disparities unchanged)."""
    left_c, cam_c = center_crop(left, stereo.cam, target_h, target_w)
    h, w = right.shape[:2]
    y0, x0 = center_crop_offsets(h, w, target_h, target_w)
    right_c = right[y0:y0 + target_h, x0:x0 + target_w]
    return left_c, right_c, StereoModel(
        cam=cam_c, baseline=stereo.baseline,
        base_from_camera=stereo.base_from_camera)
