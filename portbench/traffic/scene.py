"""Stereo pairs of a moving-planes world, rendered on the device from a
seed: the serving cells' traffic.

Adapted from ``moving_object_detector_tpu_torch/io/scenes.py``
(``PlanarSceneSequence._cast`` and ``_bilinear``) at fc97bde, frozen here
so that a later change to the program's renderer does not move the
benchmark, and written in PyTorch so that set-up renders a whole drive in
a few calls on the card. The textures are a copy of
``tests/fixtures/real_textures.npz`` (``real_textures.npz`` beside this
file).

A traffic mix names its scene, a file of ``scenes/``, and may change
some of its keys (``scene_changes``). The world: a textured background plane (optionally tilted), fixed
textured planes standing in it, and ``movers``: textured rectangles that
keep their depth in the camera's frame (they drive or walk along with
it) while they pace sideways between two limits at a constant speed.
The camera moves and yaws at constant rates; the right view sits
``baseline`` along the camera's x axis, so disparity = fx * baseline / z.
Rendering casts every pixel's ray and keeps the nearest hit, in both
views.

The seed chooses only the textures, each mover's starting place within
its limits and its first direction: every seed renders the same set of
sizes, depths and speeds, in another arrangement.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

TEXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "real_textures.npz")
# The photographs a scene may draw; the held-out ones are smaller and
# left to the program's own quality tests.
PHOTOS = ("china", "flower", "hopper")


def params(mix: dict) -> dict:
    """The scene a traffic mix names: ``scenes/<scene>.json`` beside this
    file, with the mix's ``scene_changes`` over it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scenes", mix["scene"] + ".json")
    with open(path) as f:
        scene = json.load(f)
    return dict(scene, **mix.get("scene_changes", {}))


def load_textures(device) -> list:
    with np.load(TEXTURES) as data:
        return [torch.from_numpy(data[k].astype(np.float32) / 255.0).to(device)
                for k in PHOTOS]


def _bilinear(tex: torch.Tensor, uu: torch.Tensor, vv: torch.Tensor,
              wrap: bool) -> torch.Tensor:
    """Sample ``tex`` (th, tw) at float coordinates, wrapped or clamped."""
    th, tw = tex.shape
    if wrap:
        uu = torch.remainder(uu, tw)
        vv = torch.remainder(vv, th)
    u0 = torch.floor(uu)
    v0 = torch.floor(vv)
    fu = (uu - u0).float()
    fv = (vv - v0).float()
    u0 = u0.long()
    v0 = v0.long()
    if wrap:
        u1 = torch.remainder(u0 + 1, tw)
        v1 = torch.remainder(v0 + 1, th)
        u0 = torch.remainder(u0, tw)
        v0 = torch.remainder(v0, th)
    else:
        u0 = u0.clamp(0, tw - 1)
        v0 = v0.clamp(0, th - 1)
        u1 = (u0 + 1).clamp(0, tw - 1)
        v1 = (v0 + 1).clamp(0, th - 1)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


def _yaw(theta: float) -> torch.Tensor:
    c, s = math.cos(theta), math.sin(theta)
    return torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                        dtype=torch.float64)


def pace(lo: float, hi: float, speed: float, phase: float, t: float) -> float:
    """Position at time ``t`` of a walker pacing between ``lo`` and ``hi``
    at ``speed``, having started at ``phase`` (in [0, 1)) of its round
    trip."""
    span = hi - lo
    if span <= 0 or speed <= 0:
        return lo
    period = 2.0 * span / speed
    x = ((phase * period + t) % period) * speed
    return lo + (x if x <= span else 2.0 * span - x)


class Scene:
    """The world of one traffic mix and seed."""

    def __init__(self, params: dict, height: int, width: int, fx: float,
                 baseline: float, seed: int, device):
        rng = np.random.default_rng(seed)
        self.h, self.w = int(height), int(width)
        self.fx = float(fx)
        self.cx, self.cy = self.w / 2.0, self.h / 2.0
        self.baseline = float(baseline)
        self.fps = float(params["fps"])
        self.device = torch.device(device)
        self.cam_velocity = torch.tensor(params["cam_velocity"],
                                         dtype=torch.float64)
        self.yaw_rate = float(params["yaw_rate"])
        self.bg_depth = float(params["bg_depth"])
        n = torch.tensor(params["bg_normal"], dtype=torch.float64)
        self.bg_normal = n / n.norm()
        photos = load_textures(self.device)

        def crop(th: int, tw: int) -> torch.Tensor:
            tex = photos[int(rng.integers(len(photos)))]
            y0 = int(rng.integers(tex.shape[0] - th + 1))
            x0 = int(rng.integers(tex.shape[1] - tw + 1))
            img = tex[y0:y0 + th, x0:x0 + tw]
            return torch.flip(img, (1,)) if rng.random() < 0.5 else img

        self.bg_tex = photos[int(rng.integers(len(photos)))]
        self.bg_offset = (float(rng.uniform(0, self.bg_tex.shape[1])),
                          float(rng.uniform(0, self.bg_tex.shape[0])))
        self.bg_scale = self.bg_depth / self.fx  # one texel a pixel
        tex_hw = params["texture_hw"]
        self.statics = [dict(center=tuple(s["center"]), size=tuple(s["size"]),
                             texture=crop(*tex_hw))
                        for s in params["static"]]
        self.movers = []
        for m in params["movers"]:
            self.movers.append(dict(
                z=float(m["z"]), y=float(m["y"]), size=tuple(m["size"]),
                span=tuple(m["span"]), speed=float(m["speed"]),
                phase=float(rng.random()), texture=crop(*tex_hw)))

    def camera_pose(self, k: int):
        t = k / self.fps
        return _yaw(self.yaw_rate * t), self.cam_velocity * t

    def _cast(self, k: int, right: bool) -> torch.Tensor:
        dev = self.device
        t = k / self.fps
        r, p = self.camera_pose(k)
        base = torch.tensor([self.baseline if right else 0.0, 0.0, 0.0],
                            dtype=torch.float64)
        c = (p + r @ base).to(dev)
        rd = r.to(dev)
        vs, us = torch.meshgrid(
            torch.arange(self.h, dtype=torch.float64, device=dev),
            torch.arange(self.w, dtype=torch.float64, device=dev),
            indexing="ij")
        d_cam = torch.stack([(us - self.cx) / self.fx,
                             (vs - self.cy) / self.fx,
                             torch.ones_like(us)], dim=-1)
        w_dir = d_cam @ rd.T
        nrm = self.bg_normal.to(dev)
        p0 = torch.tensor([0.0, 0.0, self.bg_depth], dtype=torch.float64,
                          device=dev)
        depth = (nrm @ (p0 - c)) / (w_dir @ nrm)
        xw = c + depth[..., None] * w_dir
        img = _bilinear(self.bg_tex, xw[..., 0] / self.bg_scale
                        + self.bg_offset[0],
                        xw[..., 1] / self.bg_scale + self.bg_offset[1], True)
        for s in self.statics:  # fronto-parallel in the world
            ctr = torch.tensor(s["center"], dtype=torch.float64, device=dev)
            s_o = (ctr[2] - c[2]) / w_dir[..., 2]
            hit = c + s_o[..., None] * w_dir
            img, depth = self._shade(img, depth, s_o, hit[..., 0] - ctr[0],
                                     hit[..., 1] - ctr[1], s["size"],
                                     s["texture"])
        cam_c = base.to(dev)  # the movers live in the camera's frame
        for m in self.movers:
            mx = pace(m["span"][0], m["span"][1], m["speed"], m["phase"], t)
            s_o = torch.full_like(depth, m["z"])
            hx = cam_c[0] + s_o * d_cam[..., 0] - mx
            hy = cam_c[1] + s_o * d_cam[..., 1] - m["y"]
            img, depth = self._shade(img, depth, s_o, hx, hy, m["size"],
                                     m["texture"])
        return img.float()

    @staticmethod
    def _shade(img, depth, s_o, hx, hy, size, tex):
        """Paint a rectangle of ``size`` (w, h) m hit at ray parameter
        ``s_o`` with local offsets (hx, hy) from its centre where it is
        nearer than ``depth``."""
        inside = ((hx.abs() <= size[0] / 2.0) & (hy.abs() <= size[1] / 2.0)
                  & (s_o > 0.05) & (s_o < depth))
        th, tw = tex.shape
        ou = (hx + size[0] / 2.0) / size[0] * (tw - 1)
        ov = (hy + size[1] / 2.0) / size[1] * (th - 1)
        shade = _bilinear(tex, ou, ov, False).to(img.dtype)
        return torch.where(inside, shade, img), torch.where(inside, s_o, depth)

    def pair(self, k: int):
        return self._cast(k, False), self._cast(k, True)


def render(params: dict, height: int, width: int, fx: float, baseline: float,
           seed: int, device) -> np.ndarray:
    """(N, 2, H, W) f32 left and right views of the scene's
    ``params["pairs"]`` distinct frames, on the host."""
    scene = Scene(params, height, width, fx, baseline, seed, device)
    out = torch.empty((params["pairs"], 2, height, width),
                      dtype=torch.float32, device=device)
    for k in range(params["pairs"]):
        out[k, 0], out[k, 1] = scene.pair(k)
    return out.cpu().numpy()


def playback(distinct: int, j: int) -> int:
    """The frame shown at step ``j`` of a drive played forward and then
    back over ``distinct`` frames, so the motion stays continuous."""
    period = 2 * (distinct - 1)
    k = j % period
    return k if k < distinct else period - k
