"""Exact-ground-truth planar-scene stereo sequence renderer (the JAX
package's ``io/scenes.py``, numpy only, copied: the same arguments and
seed render the same frames and truth bit for bit).

The richer successor to ``readers.SyntheticStereoSequence`` — the analog of
the reference's Gazebo validation world (docker/dockerfile:121-124,
README.md:54-68: a joystick-driven stereo robot and a movable box), but with
ANALYTIC ground truth for every product the pipeline estimates:

* per-pixel disparity of the left view (exact, occlusion-aware),
* per-pixel optical flow between consecutive left frames (the true motion
  field in the pipeline's convention: prev -> now displacement indexed at
  the now frame, sceneflow.py), plus a prev-visibility mask so evaluation
  can separate occlusion-region error,
* the camera ego-motion T_prev2now (scene_flow_constructor.cpp:214-256
  contract: camera-frame SE(3) mapping previous-frame coordinates to now),
* per-object camera-frame center / bounding box / velocity / image box /
  visible-pixel count (MovingObject contract, moving_object_msgs).

Scene model: the world is a set of fronto-parallel textured planes — an
infinite background plane plus N finite rectangle "objects", each moving at
a constant 3D world velocity (including depth motion). The camera
translates with constant world velocity and yaws at a constant rate about
its y axis; the stereo pair is rectified with the right camera displaced by
``baseline`` along the camera x axis (disparity = fx*b/z_cam holds for any
scene under rectification). Rendering is per-pixel exact ray casting with
front-to-back depth resolution, so occlusions between crossing objects are
geometrically correct in both views, in the disparity GT and in the flow
visibility mask.

Textures may be procedural or real photographs
(tests/fixtures/real_textures.npz) — the real-sequence evaluation gates
(tests/test_real_sequence.py) render held-out photos the flow net never
trained on.

Pure NumPy on the host (fixture generation / scoring, not a hot path).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass
class PlaneObject:
    """A textured, fronto-parallel rectangle moving at constant 3D world
    velocity. ``center0`` is the world (x, y, z) of the rectangle center at
    t = 0; ``size`` its (width, height) in meters; ``velocity`` m/s."""

    center0: tuple
    size: tuple
    velocity: tuple
    texture: np.ndarray

    def center(self, t: float) -> np.ndarray:
        return np.asarray(self.center0, np.float64) + np.asarray(
            self.velocity, np.float64
        ) * t


def _bilinear(tex: np.ndarray, uu: np.ndarray, vv: np.ndarray, wrap: bool):
    """Sample tex (th, tw) at float coords (uu, vv); wrap or clamp."""
    th, tw = tex.shape
    if wrap:
        uu = np.mod(uu, tw)
        vv = np.mod(vv, th)
    u0 = np.floor(uu).astype(np.int64)
    v0 = np.floor(vv).astype(np.int64)
    fu = (uu - u0).astype(np.float32)
    fv = (vv - v0).astype(np.float32)
    if wrap:
        u1 = np.mod(u0 + 1, tw)
        v1 = np.mod(v0 + 1, th)
        u0 = np.mod(u0, tw)
        v0 = np.mod(v0, th)
    else:
        u0 = np.clip(u0, 0, tw - 1)
        v0 = np.clip(v0, 0, th - 1)
        u1 = np.clip(u0 + 1, 0, tw - 1)
        v1 = np.clip(v0 + 1, 0, th - 1)
    a = tex[v0, u0]
    b = tex[v0, u1]
    c = tex[v1, u0]
    d = tex[v1, u1]
    return (
        a * (1 - fu) * (1 - fv)
        + b * fu * (1 - fv)
        + c * (1 - fu) * fv
        + d * fu * fv
    ).astype(np.float32)


def _as_float_texture(tex: np.ndarray) -> np.ndarray:
    tex = np.asarray(tex, np.float32)
    if tex.max() > 1.5:  # uint8-range input
        tex = tex / 255.0
    return tex


def _yaw_matrix(theta: float) -> np.ndarray:
    """Rotation about the camera/world y axis (x-z plane yaw)."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array(
        [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64
    )


class PlanarSceneSequence:
    """Render a stereo sequence of the moving-planes world with exact GT.

    Args:
      height/width/fx/fy/cx/cy/baseline: rectified stereo intrinsics
        (defaults mirror the KITTI-like working resolution,
        detect_with_zed.launch:4-5).
      bg_depth: world z of the infinite background plane (m).
      bg_texture: background texture (tiled; meters-per-texel is chosen so
        one texel spans one pixel at bg_depth).
      objects: list of PlaneObject.
      cam_velocity: world-frame camera translation rate (m/s).
      yaw_rate: camera yaw rate about +y (rad/s).
      fps / n_frames: timeline.
    """

    def __init__(
        self,
        height: int = 192,
        width: int = 448,
        fx: float = 300.0,
        fy: float | None = None,
        cx: float | None = None,
        cy: float | None = None,
        baseline: float = 0.54,
        bg_depth: float = 12.0,
        bg_texture: np.ndarray | None = None,
        objects: list | None = None,
        cam_velocity: tuple = (0.0, 0.0, 0.0),
        yaw_rate: float = 0.0,
        fps: float = 10.0,
        n_frames: int = 8,
        seed: int = 0,
        bg_normal: tuple = (0.0, 0.0, 1.0),
    ):
        self.h, self.w = int(height), int(width)
        self.fx = float(fx)
        self.fy = float(fy) if fy is not None else float(fx)
        self.cx = float(cx) if cx is not None else width / 2.0
        self.cy = float(cy) if cy is not None else height / 2.0
        self.baseline = float(baseline)
        self.bg_depth = float(bg_depth)
        # World-frame unit normal of the background plane (through
        # (0, 0, bg_depth)). The default (0, 0, 1) is the fronto-parallel
        # plane; a tilted normal (e.g. a ground-like
        # slope) breaks the fronto-parallel degeneracy that motivated the
        # ego-motion MSAC fix, so slope scenes validate its
        # generalization. Every GT product
        # (depth/disparity/flow/visibility) falls out of the raycast
        # unchanged.
        n = np.asarray(bg_normal, np.float64)
        self.bg_normal = n / np.linalg.norm(n)
        self.cam_velocity = np.asarray(cam_velocity, np.float64)
        self.yaw_rate = float(yaw_rate)
        self.fps = float(fps)
        self.n_frames = int(n_frames)
        rng = np.random.default_rng(seed)
        if bg_texture is None:
            bg_texture = _procedural_texture(rng, 512, 512)
        self.bg_tex = _as_float_texture(bg_texture)
        # one texel per pixel at bg depth
        self.bg_scale = self.bg_depth / self.fx  # meters per texel
        self.objects = [
            dataclasses.replace(o, texture=_as_float_texture(o.texture))
            for o in (objects or [])
        ]

    # --- camera trajectory -------------------------------------------------
    def camera_pose(self, k: int):
        """World-from-camera pose at frame k: (R, p) with X_w = R X_c + p."""
        t = k / self.fps
        return _yaw_matrix(self.yaw_rate * t), self.cam_velocity * t

    def gt_motion(self, k: int) -> np.ndarray:
        """T_prev2now (4x4, f32): camera-frame motion from frame k-1 to k,
        P_now = T * P_prev for static points (transformPCPreviousToNow,
        scene_flow_constructor.cpp:409-429 convention)."""
        r_prev, p_prev = self.camera_pose(max(k - 1, 0))
        r_now, p_now = self.camera_pose(k)
        rot = r_now.T @ r_prev
        trans = r_now.T @ (p_prev - p_now)
        out = np.eye(4, dtype=np.float64)
        out[:3, :3] = rot
        out[:3, 3] = trans
        return out.astype(np.float32)

    # --- ray casting -------------------------------------------------------
    def _cast(self, k: int, right: bool):
        """Cast all pixels of one view at frame k.

        Returns (img, depth, plane_id, world_pts):
          plane_id: -1 = background, i >= 0 = objects[i];
          depth: camera-frame z of the hit (== ray parameter, dz = 1);
          world_pts: (H, W, 3) world hit coordinates.
        """
        t = k / self.fps
        r, p = self.camera_pose(k)
        c = p + (r @ np.array([self.baseline, 0.0, 0.0]) if right else 0.0)

        us, vs = np.meshgrid(
            np.arange(self.w, dtype=np.float64),
            np.arange(self.h, dtype=np.float64),
        )
        d_cam = np.stack(
            [
                (us - self.cx) / self.fx,
                (vs - self.cy) / self.fy,
                np.ones_like(us),
            ],
            axis=-1,
        )  # (H, W, 3), z-component 1 -> ray parameter == camera depth
        w_dir = d_cam @ r.T  # world direction

        # Background plane through (0, 0, bg_depth) with normal
        # self.bg_normal (always hit: |yaw| and the tilt are assumed
        # small enough that every forward ray keeps n . dir > 0).
        wz = w_dir[..., 2]
        nrm = self.bg_normal
        p0 = np.array([0.0, 0.0, self.bg_depth])
        s_bg = (nrm @ (p0 - c)) / (w_dir @ nrm)
        depth = s_bg.copy()
        pid = np.full((self.h, self.w), -1, np.int32)
        xw = c[None, None, :] + s_bg[..., None] * w_dir

        for i, obj in enumerate(self.objects):
            ctr = obj.center(t)
            s_o = (ctr[2] - c[2]) / wz
            hx = c[0] + s_o * w_dir[..., 0] - ctr[0]
            hy = c[1] + s_o * w_dir[..., 1] - ctr[1]
            inside = (
                (np.abs(hx) <= obj.size[0] / 2.0)
                & (np.abs(hy) <= obj.size[1] / 2.0)
                & (s_o > 0.05)
            )
            closer = inside & (s_o < depth)
            depth = np.where(closer, s_o, depth)
            pid = np.where(closer, np.int32(i), pid)
            xw = np.where(
                closer[..., None],
                c[None, None, :] + s_o[..., None] * w_dir,
                xw,
            )

        # Shade
        img = np.empty((self.h, self.w), np.float32)
        bg_u = xw[..., 0] / self.bg_scale
        bg_v = xw[..., 1] / self.bg_scale
        img[:] = _bilinear(self.bg_tex, bg_u, bg_v, wrap=True)
        for i, obj in enumerate(self.objects):
            m = pid == i
            if not m.any():
                continue
            ctr = obj.center(t)
            th, tw = obj.texture.shape
            ou = (xw[..., 0] - ctr[0] + obj.size[0] / 2.0) / obj.size[0] * (
                tw - 1
            )
            ov = (xw[..., 1] - ctr[1] + obj.size[1] / 2.0) / obj.size[1] * (
                th - 1
            )
            shade = _bilinear(obj.texture, ou, ov, wrap=False)
            img = np.where(m, shade, img)
        return img, depth.astype(np.float32), pid, xw

    # --- public products ---------------------------------------------------
    def frame(self, k: int):
        """(left, right, t, truth) — truth carries the exact per-frame GT."""
        left, depth, pid, xw = self._cast(k, right=False)
        right_img, _, _, _ = self._cast(k, right=True)
        truth = self._truth(k, depth, pid, xw)
        return left, right_img, k / self.fps, truth

    def _truth(self, k: int, depth, pid, xw):
        t = k / self.fps
        dt = 1.0 / self.fps
        r_now, p_now = self.camera_pose(k)
        disparity = (self.fx * self.baseline / depth).astype(np.float32)

        # True motion-field flow (prev -> now, indexed at now): where was
        # this material point at t - dt, in the previous left view?
        r_prev, p_prev = self.camera_pose(k - 1)
        vel_w = np.zeros_like(xw)
        for i, obj in enumerate(self.objects):
            vel_w = np.where(
                (pid == i)[..., None],
                np.asarray(obj.velocity, np.float64)[None, None, :],
                vel_w,
            )
        x_prevw = xw - vel_w * dt
        pc = (x_prevw - p_prev[None, None, :]) @ r_prev  # camera coords
        with np.errstate(divide="ignore", invalid="ignore"):
            up = self.fx * pc[..., 0] / pc[..., 2] + self.cx
            vp = self.fy * pc[..., 1] / pc[..., 2] + self.cy
        us, vs = np.meshgrid(
            np.arange(self.w, dtype=np.float64),
            np.arange(self.h, dtype=np.float64),
        )
        flow = np.stack([us - up, vs - vp], axis=-1).astype(np.float32)
        if k == 0:
            flow = np.zeros_like(flow)

        # Visibility at prev: the material point was visible in the
        # previous left frame iff the previous frame's plane-id map at its
        # projection matches (occlusion / out-of-frame mask for flow eval).
        if k > 0:
            _, _, pid_prev, _ = self._cast(k - 1, right=False)
            ui = np.clip(np.round(up).astype(np.int64), 0, self.w - 1)
            vi = np.clip(np.round(vp).astype(np.int64), 0, self.h - 1)
            in_frame = (
                (up >= 0) & (up <= self.w - 1) & (vp >= 0)
                & (vp <= self.h - 1) & (pc[..., 2] > 0)
            )
            prev_visible = in_frame & (pid_prev[vi, ui] == pid)
        else:
            prev_visible = np.zeros((self.h, self.w), bool)

        objects = []
        for i, obj in enumerate(self.objects):
            ctr_w = obj.center(t)
            ctr_cam = r_now.T @ (ctr_w - p_now)
            vel_cam = r_now.T @ np.asarray(obj.velocity, np.float64)
            vis = pid == i
            n_vis = int(vis.sum())
            if n_vis:
                ys, xs = np.nonzero(vis)
                px_box = (
                    int(ys.min()), int(xs.min()),
                    int(ys.max() - ys.min() + 1),
                    int(xs.max() - xs.min() + 1),
                )
            else:
                px_box = None
            objects.append(
                {
                    "center_cam": ctr_cam.astype(np.float32),
                    "velocity_cam": vel_cam.astype(np.float32),
                    "bbox_m": (
                        float(obj.size[0]), float(obj.size[1]), 0.0
                    ),
                    "px_box": px_box,
                    "visible_px": n_vis,
                }
            )

        return {
            "disparity": disparity,
            "flow": flow,
            "prev_visible": prev_visible,
            "plane_id": pid,
            "motion_prev2now": self.gt_motion(k),
            "objects": objects,
            # Back-compat with SyntheticStereoSequence truth consumers:
            # the first object's pixel box and camera-frame velocity.
            "obj_box": (
                (
                    objects[0]["px_box"][0], objects[0]["px_box"][1],
                    objects[0]["px_box"][2], objects[0]["px_box"][3],
                )
                if objects and objects[0]["px_box"]
                else (0, 0, 0, 0)
            ),
            "velocity": (
                tuple(objects[0]["velocity_cam"]) if objects else (0, 0, 0)
            ),
        }

    def __iter__(self):
        for k in range(self.n_frames):
            left, right, t, _ = self.frame(k)
            yield left, right, t


def _procedural_texture(rng, h, w, cell=6):
    img = np.kron(
        rng.uniform(0.1, 0.9, (h // cell + 1, w // cell + 1)),
        np.ones((cell, cell)),
    )[:h, :w].astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    img = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="same"), 1, img
    )
    return np.apply_along_axis(
        lambda c: np.convolve(c, k, mode="same"), 0, img
    ).astype(np.float32)


# --- canned validation scenes ---------------------------------------------

def validation_scenes(h=192, w=448, fx=300.0, textures=None, fps=10.0):
    """The detection-quality scene matrix: named
    scenes covering the regimes the single-object lateral gate missed.
    ``textures``: dict name->array (e.g. the real-photo fixture); falls
    back to procedural textures.
    """
    rng = np.random.default_rng(7)
    tex = dict(textures or {})

    def pick(name, th, tw):
        if name in tex:
            return tex[name]
        # zlib.crc32, not hash(): str hash is per-process randomized
        # (PYTHONHASHSEED), which would make the "canned" scenes differ
        # between runs.
        return _procedural_texture(
            np.random.default_rng(zlib.crc32(name.encode()) % 2**31),
                                   th, tw, cell=3)

    # Pixel-to-world sizing: an object meant to span ~opx pixels at depth z
    # has world size opx * z / fx.
    def msize(opx_w, opx_h, z):
        return (opx_w * z / fx, opx_h * z / fx)

    scenes = {}
    scenes["lateral"] = PlanarSceneSequence(
        h, w, fx=fx, bg_texture=pick("bg", 512, 512),
        objects=[PlaneObject(
            center0=(-1.0, 0.0, 6.0), size=msize(110, 70, 6.0),
            velocity=(2.0, 0.0, 0.0), texture=pick("obj1", 96, 128),
        )],
        fps=fps, n_frames=8,
    )
    scenes["multi_object"] = PlanarSceneSequence(
        h, w, fx=fx, bg_texture=pick("bg", 512, 512),
        objects=[
            # Vertically separated rows (no image overlap): two
            # independent simultaneous tracks.
            PlaneObject(
                center0=(-1.2, -0.75, 6.0), size=msize(100, 64, 6.0),
                velocity=(2.0, 0.0, 0.0), texture=pick("obj1", 96, 128),
            ),
            PlaneObject(
                center0=(1.3, 0.9, 8.0), size=msize(110, 70, 8.0),
                velocity=(-1.8, 0.0, 0.0), texture=pick("obj2", 96, 128),
            ),
        ],
        fps=fps, n_frames=8,
    )
    # Two objects whose image paths CROSS: the nearer occludes the farther
    # mid-sequence (clusterer_nodelet.cpp:56-83 depth gate must keep them
    # separate clusters; the tracker must survive the occlusion).
    scenes["occlusion"] = PlanarSceneSequence(
        h, w, fx=fx, bg_texture=pick("bg", 512, 512),
        objects=[
            # Start fully separated in the image (at the default 448-px
            # width); the image paths cross around frame ~7.
            PlaneObject(
                center0=(-1.6, 0.0, 5.5), size=msize(100, 64, 5.5),
                velocity=(2.2, 0.0, 0.0), texture=pick("obj1", 96, 128),
            ),
            PlaneObject(
                center0=(1.6, 0.0, 8.5), size=msize(110, 70, 8.5),
                velocity=(-2.2, 0.0, 0.0), texture=pick("obj2", 96, 128),
            ),
        ],
        fps=fps, n_frames=8,
    )
    # Depth-approaching object (velocity mostly -z toward the camera).
    scenes["approach"] = PlanarSceneSequence(
        h, w, fx=fx, bg_texture=pick("bg", 512, 512),
        objects=[PlaneObject(
            center0=(0.4, 0.1, 11.0), size=msize(90, 60, 11.0),
            velocity=(0.3, 0.0, -3.0), texture=pick("obj1", 96, 128),
        )],
        fps=fps, n_frames=8,
    )
    # Rotating camera (yaw pan) + translating: the ego-motion stage must
    # absorb the rotational flow or the whole background goes dynamic.
    scenes["rotating_cam"] = PlanarSceneSequence(
        h, w, fx=fx, bg_texture=pick("bg", 512, 512),
        objects=[PlaneObject(
            center0=(-0.8, 0.0, 6.0), size=msize(110, 70, 6.0),
            velocity=(2.0, 0.0, 0.0), texture=pick("obj1", 96, 128),
        )],
        cam_velocity=(0.6, 0.0, 0.0), yaw_rate=np.deg2rad(2.0),
        fps=fps, n_frames=8,
    )
    # Sloped (ground-like, 25 deg) background + rotating/translating
    # camera: every scene above is fronto-parallel, exactly the
    # degeneracy where RANSAC can trade yaw against lateral translation
    # (the measured failure the ego-motion MSAC fix addressed). A tilted
    # background carries per-row depth gradients that pin the pose, so
    # this scene validates the fix's generalization off the degenerate
    # geometry.
    scenes["sloped_bg"] = PlanarSceneSequence(
        h, w, fx=fx, bg_texture=pick("bg", 512, 512),
        bg_normal=(0.0, np.sin(np.deg2rad(25.0)),
                   np.cos(np.deg2rad(25.0))),
        objects=[PlaneObject(
            center0=(-0.9, 0.0, 6.0), size=msize(110, 70, 6.0),
            velocity=(2.0, 0.0, 0.0), texture=pick("obj1", 96, 128),
        )],
        cam_velocity=(0.6, 0.0, 0.0), yaw_rate=np.deg2rad(2.0),
        fps=fps, n_frames=8,
    )
    return scenes


class InteractiveSceneSequence(PlanarSceneSequence):
    """Human-DRIVABLE scene: the Gazebo joystick parity item.

    The reference's simulation harness is a factory world with a
    joystick-driven stereo robot and a movable object a human steers
    while watching detections in rviz (README.md:54-68,
    docker/dockerfile:121-124). This is the in-process analog: the same
    raycast renderer, but camera / object velocities are COMMANDS
    integrated per frame instead of fixed trajectories. ``command()`` is
    thread-safe and wired to the live dashboard's POST /sim endpoint
    (io/dashboard.py) — drive with WASD/arrow buttons in the same pane
    that shows the detections.

    Commands (any subset per call):
      cam_velocity: (3,) m/s world-frame camera translation rate
      yaw_rate:     rad/s about +y
      obj_velocity: list of (3,) m/s, one per scene object (None skips)

    ``realtime=True`` paces ``__iter__`` to ``fps`` wall-clock (drop-
    oldest ring semantics upstream handle a slower consumer); False
    renders as fast as pulled (tests).
    """

    def __init__(self, *args, realtime: bool = True, **kw):
        import threading

        kw.setdefault("n_frames", 10 ** 9)
        super().__init__(*args, **kw)
        self._lock = threading.Lock()
        self._cam_pos = np.zeros(3)
        self._yaw = 0.0
        self._obj_pos = [
            np.asarray(o.center0, np.float64) for o in self.objects
        ]
        self._cmd_cam = np.asarray(self.cam_velocity, np.float64).copy()
        self._cmd_yaw = float(self.yaw_rate)
        self._cmd_obj = [
            np.asarray(o.velocity, np.float64).copy() for o in self.objects
        ]
        self.realtime = bool(realtime)
        self._stop = False

    # -- command channel (any thread) -----------------------------------
    def command(self, cam_velocity=None, yaw_rate=None, obj_velocity=None,
                **_ignored) -> dict:
        """Update steering commands; returns the applied state. Unknown
        keys are ignored (a live UI must not be able to crash the sim)."""
        with self._lock:
            if cam_velocity is not None:
                v = np.asarray(cam_velocity, np.float64).reshape(3)
                self._cmd_cam = v
            if yaw_rate is not None:
                self._cmd_yaw = float(yaw_rate)
            if obj_velocity is not None:
                for i, v in enumerate(obj_velocity):
                    if v is not None and i < len(self._cmd_obj):
                        self._cmd_obj[i] = np.asarray(
                            v, np.float64).reshape(3)
            return self.state()

    def state(self) -> dict:
        return {
            "cam_velocity": list(self._cmd_cam),
            "yaw_rate": self._cmd_yaw,
            "obj_velocity": [list(v) for v in self._cmd_obj],
            "cam_pos": list(self._cam_pos),
            "yaw": self._yaw,
            "obj_pos": [list(p) for p in self._obj_pos],
        }

    def stop(self):
        self._stop = True

    # -- integrated poses override the fixed trajectories ----------------
    def camera_pose(self, k: int):
        # k is ignored: the pose is integrated state (gt_motion/truth are
        # not produced on the interactive path).
        return _yaw_matrix(self._yaw), self._cam_pos.copy()

    def _advance(self, dt: float):
        with self._lock:
            self._cam_pos = self._cam_pos + self._cmd_cam * dt
            self._yaw += self._cmd_yaw * dt
            for i in range(len(self._obj_pos)):
                self._obj_pos[i] = (
                    self._obj_pos[i] + self._cmd_obj[i] * dt
                )

    def __iter__(self):
        import time as _time

        k = 0
        t0 = _time.time()
        period = 1.0 / self.fps
        while k < self.n_frames and not self._stop:
            with self._lock:
                # Pin each object at its integrated position (center(t)
                # must return it for any t the renderer uses).
                self.objects = [
                    dataclasses.replace(
                        o, center0=tuple(self._obj_pos[i]),
                        velocity=(0.0, 0.0, 0.0),
                    )
                    for i, o in enumerate(self.objects)
                ]
            left = self._cast(k, right=False)[0]
            right = self._cast(k, right=True)[0]
            yield left, right, k * period
            self._advance(period)
            k += 1
            if self.realtime:
                lag = t0 + k * period - _time.time()
                if lag > 0:
                    _time.sleep(lag)
