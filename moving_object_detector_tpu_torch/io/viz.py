"""Visualization exports: the RViz/rqt replacement (SURVEY.md §1 L8, §3.5).
A copy of the JAX package's ``io/viz.py`` (numpy only; object lists may
hold tensors, which are fetched to the host).

The reference renders CUBE+ARROW markers per object
(moving_object_to_marker/nodes/moving_object_to_marker:51-108), an HSV
cluster label image (color_set.cpp:16-26, clusterer_nodelet.cpp:292-322),
depth/flow debug images, and velocity point clouds. Here those become
dependency-free file products: PPM images, PLY clouds, and marker JSON.
"""

from __future__ import annotations

import json
import colorsys
from typing import Sequence

import numpy as np


def _host(x) -> np.ndarray:
    """numpy view of an array or of a tensor on any device."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def write_ppm(path: str, image: np.ndarray) -> None:
    """(H, W) grayscale or (H, W, 3) RGB float [0,1] or uint8 -> binary PPM."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(np.nan_to_num(img), 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def png_bytes(image: np.ndarray) -> bytes:
    """(H, W) grayscale or (H, W, 3) RGB float [0,1] or uint8 -> PNG bytes
    (stdlib zlib, filter 0 on every scanline; no external codecs)."""
    import struct
    import zlib

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(np.nan_to_num(img), 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, _ = img.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data))
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """PNG file form of png_bytes. Browsers render PNG but not PPM, so the
    HTML report (scripts/make_report.py) and the live dashboard
    (io/dashboard.py) use this encoder."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def label_colors(n: int) -> np.ndarray:
    """Distinct colors by evenly spaced hue — the reference's HSV color set
    (color_set.cpp:16-26). (n, 3) uint8."""
    cols = []
    for i in range(max(n, 1)):
        r, g, b = colorsys.hsv_to_rgb(i / max(n, 1), 1.0, 1.0)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return np.array(cols, np.uint8)


def colorize_labels(label_image: np.ndarray, n_labels: int | None = None):
    """(H, W) int labels (-1 = background) -> (H, W, 3) uint8, black
    background — the ``~clusters_image`` product
    (clusterer_nodelet.cpp:292-322)."""
    labels = np.asarray(label_image)
    n = int(n_labels if n_labels is not None else max(labels.max() + 1, 1))
    cols = label_colors(n)
    out = np.zeros(labels.shape + (3,), np.uint8)
    fg = labels >= 0
    out[fg] = cols[labels[fg] % n]
    return out


def flow_to_rgb(flow: np.ndarray, max_magnitude: float | None = None):
    """Optical-flow HSV wheel rendering: hue = direction, value = magnitude.
    NaN -> black. (H, W, 2) -> (H, W, 3) uint8."""
    f = np.asarray(flow)
    fx, fy = f[..., 0], f[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    valid = np.isfinite(mag)
    mm = max_magnitude or (np.percentile(mag[valid], 99) + 1e-6 if valid.any() else 1.0)
    ang = np.arctan2(-fy, -fx) / np.pi  # [-1, 1]
    h = (ang + 1.0) / 2.0
    v = np.clip(mag / mm, 0, 1)
    hsv = np.stack([h, np.ones_like(h), v], axis=-1)
    rgb = _hsv_to_rgb_vec(np.nan_to_num(hsv))
    rgb[~valid] = 0
    return (rgb * 255).astype(np.uint8)


def _hsv_to_rgb_vec(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    choices = [
        np.stack([v, t, p], -1),
        np.stack([q, v, p], -1),
        np.stack([p, v, t], -1),
        np.stack([p, q, v], -1),
        np.stack([t, p, v], -1),
        np.stack([v, p, q], -1),
    ]
    out = np.zeros(hsv.shape, hsv.dtype)
    for k, c in enumerate(choices):
        out[i == k] = c[i == k]
    return out


def velocity_image(cloud_velocity: np.ndarray, max_color_velocity: float = 1.0):
    """Per-pixel velocity magnitude rendering, intensity saturating at
    ``max_color_velocity`` (SceneFlowConstructor.cfg:9)."""
    v = np.asarray(cloud_velocity)
    mag = np.sqrt(np.nansum(v * v, axis=-1))
    mag = np.where(np.isfinite(v[..., 0]), mag, 0.0)
    return np.clip(mag / max_color_velocity, 0, 1)


def depth_image(points: np.ndarray, max_depth: float = 30.0):
    """(H, W, 3) cloud -> normalized inverse-depth image (NaN -> 0), the
    ``~depth`` debug product (scene_flow_constructor.cpp:114-119)."""
    z = np.asarray(points)[..., 2]
    img = np.where(np.isfinite(z), np.clip(z, 0, max_depth) / max_depth, 0.0)
    return 1.0 - img


def objects_to_markers(
    objects, frame_id: str = "camera", color=(1.0, 0.0, 0.0, 0.8)
) -> list[dict]:
    """MovingObjects -> marker dicts mirroring the reference's RViz
    MarkerArray semantics: a DELETEALL, then per object a CUBE (bounding
    box at the center pose) and an ARROW from center to center+velocity
    (moving_object_to_marker:51-108)."""
    markers: list[dict] = [{"action": "deleteall"}]
    ids = _host(objects.id)
    centers = _host(objects.center)
    vels = _host(objects.velocity)
    boxes = _host(objects.bounding_box)
    valid = _host(objects.valid)
    r, g, b, a = color
    for i in range(len(ids)):
        if not valid[i]:
            continue
        c = centers[i].tolist()
        markers.append(
            {
                "action": "add",
                "type": "cube",
                "ns": "moving_object",
                "id": int(ids[i]),
                "frame_id": frame_id,
                "position": c,
                "scale": boxes[i].tolist(),
                "color": [r, g, b, a],
            }
        )
        markers.append(
            {
                "action": "add",
                "type": "arrow",
                "ns": "object_velocity",
                "id": int(ids[i]),
                "frame_id": frame_id,
                "points": [c, (centers[i] + vels[i]).tolist()],
                "scale": [0.1, 0.15, 0.2],
                "color": [r, g, b, a],
            }
        )
    return markers


def write_marker_json(path: str, markers: Sequence[dict]) -> None:
    with open(path, "w") as f:
        json.dump(list(markers), f, indent=1)


def write_ply(path: str, points: np.ndarray, velocity: np.ndarray | None = None):
    """Export an organized cloud (H, W, 3) (+ optional velocities) as ASCII
    PLY, dropping NaN points — the scene-flow cloud export."""
    pts = np.asarray(points).reshape(-1, 3)
    mask = np.isfinite(pts[:, 0])
    pts = pts[mask]
    vel = None
    if velocity is not None:
        vel = np.asarray(velocity).reshape(-1, 3)[mask]
        vel = np.nan_to_num(vel)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if vel is not None:
            f.write(
                "property float vx\nproperty float vy\nproperty float vz\n"
            )
        f.write("end_header\n")
        for i in range(len(pts)):
            row = pts[i].tolist() + (vel[i].tolist() if vel is not None else [])
            f.write(" ".join(f"{v:.4f}" for v in row) + "\n")
