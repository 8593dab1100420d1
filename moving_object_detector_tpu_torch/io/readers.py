"""Sequence readers: the replacement for the reference's sensor layer.
A copy of the JAX package's ``io/readers.py`` (numpy only).

Where the reference consumes live ZED topics or Gazebo sim topics
(SURVEY.md §1 L1; detect_with_zed.launch, detect_with_gazebo.launch), this
module provides: dependency-free PGM/PNG/NPY image loading (KITTI raw ships
8-bit PNGs), directory-of-images stereo sequences, .npz recorded sequences
(the rosbag analog), and a synthetic moving-object scene generator (the
Gazebo-simulation analog, SURVEY.md §2.3 sim assets).

All readers yield (left, right, timestamp) with images as float32 [0, 1]
(H, W) grayscale arrays — the pipeline's default input contract — or
(H, W, 3) RGB when constructed with color=True (PipelineConfig.color;
the reference feeds the camera's native color image to PWC-Net,
scene_flow_constructor.cpp:279-282).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import struct
import zlib
from typing import Iterator, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Image decoding (dependency-free: PGM/PPM, 8/16-bit grayscale+RGB PNG, NPY)
# ---------------------------------------------------------------------------


def read_pgm(path: str) -> np.ndarray:
    """Binary or ASCII PGM/PPM."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, width, height, maxval; '#' comments allowed.
    tokens = []
    i = 0
    while len(tokens) < 4:
        if data[i : i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        if j > i:
            tokens.append(data[i:j])
        i = j + 1
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    channels = 3 if magic in (b"P6", b"P3") else 1
    if magic in (b"P5", b"P6"):
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        arr = np.frombuffer(data, dtype=dtype, count=w * h * channels, offset=i)
    elif magic in (b"P2", b"P3"):
        arr = np.array(data[i:].split(), dtype=np.int32)[: w * h * channels]
    else:
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")
    arr = arr.reshape((h, w, channels) if channels == 3 else (h, w))
    return arr.astype(np.float32) / float(maxval)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def read_png(path: str) -> np.ndarray:
    """Minimal PNG decoder: 8/16-bit grayscale (0) / RGB (2) / palette-free,
    non-interlaced — exactly what KITTI raw and typical dataset dumps use."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = bytearray()
    width = height = bitdepth = colortype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, comp, filt, interlace = (
                struct.unpack(">IIBBBBB", chunk)
            )
            if interlace != 0:
                raise ValueError("interlaced PNG unsupported")
            if colortype not in (0, 2):
                raise ValueError(f"PNG colortype {colortype} unsupported")
            if bitdepth not in (8, 16):
                raise ValueError(f"PNG bitdepth {bitdepth} unsupported")
        elif ctype == b"IDAT":
            idat.extend(chunk)
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(bytes(idat))
    channels = 3 if colortype == 2 else 1
    bpp = channels * (bitdepth // 8)
    stride = width * bpp
    # Scanline reconstruction in the native runtime when available: the
    # Sub/Average/Paeth filters are sequential per pixel, which as Python
    # loops cost seconds per libpng-encoded KITTI frame.
    from .frame_ring import png_defilter

    native = png_defilter(raw, height, stride, bpp)
    if native is not None:
        return _png_to_float(native, height, width, channels, bitdepth)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for x in range(bpp, stride):
                line[x] = (int(line[x]) + int(line[x - bpp])) & 0xFF
        elif ftype == 2:  # Up
            line = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                line[x] = (
                    int(line[x]) + ((int(left) + int(prev[x])) >> 1)
                ) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter {ftype} unsupported")
        out[y] = line
        prev = line
    return _png_to_float(out, height, width, channels, bitdepth)


def _png_to_float(out, height, width, channels, bitdepth):
    if bitdepth == 16:
        img = out.reshape(height, width, channels, 2)
        arr = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
        scale = 65535.0
    else:
        arr = out.reshape(height, width, channels)
        scale = 255.0
    arr = arr.astype(np.float32) / scale
    return arr[..., 0] if channels == 1 else arr


def read_image(path: str, color: bool = False) -> np.ndarray:
    """Load PGM/PPM/PNG/NPY as float32. Default: grayscale, BT.601-
    converting color sources. ``color=True``: (H, W, 3) RGB, replicating
    grayscale sources into three channels (the color pipeline contract,
    PipelineConfig.color)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        img = read_pgm(path)
    elif ext == ".png":
        img = read_png(path)
    elif ext == ".npy":
        img = np.load(path).astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
    else:
        raise ValueError(f"unsupported image format: {path}")
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]  # drop alpha
    if color:
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3], np.float32)
    if img.ndim == 3:
        img = (
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        ).astype(np.float32)
    return img


# ---------------------------------------------------------------------------
# Sequences
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImageSequence:
    """Stereo sequence from two image directories (KITTI raw layout:
    image_02/data, image_03/data or image_00/image_01 grayscale), timestamps
    at a fixed rate unless a timestamps file exists."""

    left_dir: str
    right_dir: str
    fps: float = 10.0
    color: bool = False  # yield (H, W, 3) RGB (PipelineConfig.color)

    def _timestamps(self) -> list[float] | None:
        """KITTI raw timestamps.txt next to the data dir (image_02/data ->
        image_02/timestamps.txt): ISO datetimes with nanoseconds, returned
        as seconds since the first frame."""
        for base in (os.path.dirname(self.left_dir.rstrip("/")),
                     self.left_dir):
            path = os.path.join(base, "timestamps.txt")
            if not os.path.exists(path):
                continue
            import datetime

            stamps = []
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    # datetime.fromisoformat handles only microseconds:
                    # trim the nanosecond digits.
                    head, frac = line.split(".")
                    dt = datetime.datetime.fromisoformat(
                        f"{head}.{frac[:6]}"
                    )
                    stamps.append(dt.timestamp())
            if stamps:
                t0 = stamps[0]
                return [t - t0 for t in stamps]
        return None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        lefts = sorted(glob.glob(os.path.join(self.left_dir, "*")))
        rights = sorted(glob.glob(os.path.join(self.right_dir, "*")))
        stamps = self._timestamps()
        for i, (lp, rp) in enumerate(zip(lefts, rights)):
            t = stamps[i] if stamps and i < len(stamps) else i / self.fps
            yield (read_image(lp, color=self.color),
                   read_image(rp, color=self.color), t)


@dataclasses.dataclass
class LiveDirectorySequence:
    """Live streaming source: follow a pair of GROWING directories and
    yield stereo frames as they appear — the live-camera role of the
    reference's ZED feed (detect_with_zed.launch:1-55; zed_common.yaml
    HD720@15fps), where a sensor keeps publishing while the pipeline runs.

    A frame is emitted when BOTH sides of the next index exist and each
    file's size has been stable across one poll interval (writers that
    can't rename atomically are still consumed safely). Frames the
    consumer misses are its own concern: feed this through a
    PipelineRunner built with ``drop_oldest=True`` and ``ring_capacity=1``
    for the reference's queue_size=1 drop-stale backpressure
    (scene_flow_constructor.cpp:55-62 subscriber queues).

    Termination: after ``idle_timeout`` seconds with no new frame, or as
    soon as a ``stop_file`` appears (the rosnode-shutdown analog).
    Timestamps are file mtimes relative to the first frame (falling back
    to arrival order / fps spacing when mtime is non-monotonic).
    """

    left_dir: str
    right_dir: str
    fps: float = 10.0
    poll_interval: float = 0.02
    idle_timeout: float = 10.0
    stop_file: str | None = None

    def _stable_listing(self, d: str, sizes: dict) -> list[str]:
        """Paths in ``d`` whose size is unchanged since the last poll."""
        out = []
        for p in sorted(glob.glob(os.path.join(d, "*"))):
            try:
                size = os.path.getsize(p)
            except OSError:
                continue  # disappeared between listing and stat
            if sizes.get(p) == size:
                out.append(p)
            sizes[p] = size
        return out

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        import time as _time

        lsizes: dict = {}
        rsizes: dict = {}
        emitted = 0
        t0: float | None = None
        last_t = -1.0
        last_new = _time.monotonic()
        while True:
            if self.stop_file and os.path.exists(self.stop_file):
                return
            lefts = self._stable_listing(self.left_dir, lsizes)
            rights = self._stable_listing(self.right_dir, rsizes)
            n_ready = min(len(lefts), len(rights))
            if n_ready <= emitted:
                if _time.monotonic() - last_new > self.idle_timeout:
                    return
                _time.sleep(self.poll_interval)
                continue
            for i in range(emitted, n_ready):
                lp, rp = lefts[i], rights[i]
                try:
                    left, right = read_image(lp), read_image(rp)
                except Exception:
                    # Size stable across one poll yet undecodable: a writer
                    # stalled mid-file longer than the poll interval. Force
                    # both paths to re-stabilize and retry next poll (the
                    # idle timeout still bounds a permanently-corrupt file).
                    lsizes.pop(lp, None)
                    rsizes.pop(rp, None)
                    break
                try:
                    mtime = max(os.path.getmtime(lp), os.path.getmtime(rp))
                except OSError:
                    mtime = 0.0
                if t0 is None:
                    t0 = mtime
                t = mtime - t0
                if t <= last_t:  # non-monotonic mtimes: fps spacing
                    t = last_t + 1.0 / self.fps
                last_t = t
                yield left, right, t
                emitted = i + 1
                last_new = _time.monotonic()


_SOCK_MAGIC = b"MODT"


def write_socket_frame(sock, left: np.ndarray, right: np.ndarray,
                       t: float) -> None:
    """Send one stereo frame over a connected socket (the camera side of
    SocketStereoSequence's wire format). Images are (H, W) float32 [0, 1]
    or uint8; sent as uint8 + a float64 timestamp."""
    def as_u8(img):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
            img = np.round(img * 255.0).astype(np.uint8)
        return img

    l8, r8 = as_u8(left), as_u8(right)
    if l8.shape != r8.shape:
        raise ValueError(f"stereo shape mismatch {l8.shape} vs {r8.shape}")
    h, w = l8.shape
    header = _SOCK_MAGIC + struct.pack("<IId", h, w, float(t))
    sock.sendall(header + l8.tobytes() + r8.tobytes())


@dataclasses.dataclass
class SocketStereoSequence:
    """Live streaming source over TCP: the in-process stand-in for a
    network camera / remote sensor node (the reference's ZED feed arrived
    over TCPROS from another process, docker-compose.yml:14-16 +
    detect_with_zed.launch:1-55).

    Wire format per frame: b"MODT" + <u32 H><u32 W><f64 t> + H*W uint8
    left + H*W uint8 right. The reader CONNECTS to ``host:port`` (the
    sensor is the server, as a camera daemon would be) and yields frames
    until the peer closes or ``idle_timeout`` passes with no data. Pair
    with a drop-oldest PipelineRunner ring for queue_size=1 backpressure
    (scene_flow_constructor.cpp:55-62 semantics).
    """

    host: str = "127.0.0.1"
    port: int = 0
    idle_timeout: float = 10.0
    connect_retries: int = 50
    connect_retry_interval: float = 0.1

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        import socket
        import time as _time

        sock = None
        last_err = None
        for _ in range(max(1, self.connect_retries)):
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=self.idle_timeout
                )
                break
            except OSError as e:  # server not up yet
                last_err = e
                _time.sleep(self.connect_retry_interval)
        if sock is None:
            raise ConnectionError(
                f"could not connect to {self.host}:{self.port}: {last_err}"
            )
        head_len = len(_SOCK_MAGIC) + struct.calcsize("<IId")

        def recv_exact(n: int) -> bytes | None:
            buf = bytearray()
            while len(buf) < n:
                try:
                    chunk = sock.recv(n - len(buf))
                except socket.timeout:
                    return None  # idle
                if not chunk:  # peer closed
                    return None
                buf.extend(chunk)
            return bytes(buf)

        with sock:
            while True:
                head = recv_exact(head_len)
                if head is None:
                    return
                if head[:4] != _SOCK_MAGIC:
                    raise ValueError(
                        f"bad frame magic {head[:4]!r} (desynchronized "
                        f"stream)"
                    )
                h, w, t = struct.unpack("<IId", head[4:])
                if not (0 < h <= 8192 and 0 < w <= 8192):
                    raise ValueError(f"implausible frame dims {h}x{w}")
                payload = recv_exact(2 * h * w)
                if payload is None:
                    return  # truncated final frame / idle mid-frame
                frame = np.frombuffer(payload, np.uint8).reshape(2, h, w)
                left = frame[0].astype(np.float32) / 255.0
                right = frame[1].astype(np.float32) / 255.0
                yield left, right, float(t)


@dataclasses.dataclass
class NpzSequence:
    """Recorded sequence from a single .npz: arrays 'left' (N, H, W[, 3]),
    'right' (N, H, W[, 3]), optional 'time' (N,) — the rosbag analog.
    Channel handling mirrors read_image: color bags collapse to BT.601
    luma unless color=True; grayscale bags replicate when color=True."""

    path: str
    color: bool = False

    @staticmethod
    def _convert(img: np.ndarray, color: bool) -> np.ndarray:
        if color:
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            return np.ascontiguousarray(img[..., :3], np.float32)
        if img.ndim == 3:
            img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                   + 0.114 * img[..., 2])
        return np.asarray(img, np.float32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        data = np.load(self.path)
        left, right = data["left"], data["right"]
        times = data["time"] if "time" in data else np.arange(len(left)) * 0.1
        for l, r, t in zip(left, right, times):
            yield (self._convert(l, self.color),
                   self._convert(r, self.color), float(t))


class SyntheticStereoSequence:
    """Procedural moving-object stereo scene — the Gazebo-simulation analog
    (SURVEY.md §2.3): a textured two-depth background and a textured block
    moving laterally at constant velocity, rendered into a rectified stereo
    pair via per-region disparity shifts.

    Ground truth (object pixel rectangle, velocity) is exposed per frame for
    parity testing.
    """

    def __init__(
        self,
        height=376,
        width=1242,
        fx=721.5,
        baseline=0.54,
        z_bg=12.0,
        z_obj=6.0,
        obj_size=None,  # default: (height // 4, width // 6)
        obj_speed_px=6.0,
        fps=10.0,
        seed=0,
        n_frames=40,
        bg_texture=None,
        obj_texture=None,
    ):
        self.h, self.w = height, width
        self.fx = fx
        self.baseline = baseline
        self.z_bg, self.z_obj = z_bg, z_obj
        if obj_size is None:
            obj_size = (height // 4, width // 6)
        self.obj_h, self.obj_w = obj_size
        self.speed = obj_speed_px
        self.fps = fps
        self.n_frames = n_frames
        rng = np.random.default_rng(seed)
        # bg/obj textures are injectable: tests/test_real_imagery.py renders
        # the same scene geometry with REAL photographic textures
        # (tests/fixtures/real_textures.npz) instead of the procedural ones.
        self.bg = (
            self._fit_texture(bg_texture, height, width)
            if bg_texture is not None
            else self._texture(rng, height, width, cell=6)
        )
        self.obj = (
            self._fit_texture(obj_texture, self.obj_h, self.obj_w)
            if obj_texture is not None
            else self._texture(rng, self.obj_h, self.obj_w, cell=3)
        )
        self.obj_y = height // 3
        self.obj_x0 = width // 6
        self.d_bg = fx * baseline / z_bg
        self.d_obj = fx * baseline / z_obj

    @staticmethod
    def _fit_texture(tex: np.ndarray, h: int, w: int) -> np.ndarray:
        """Fit an arbitrary grayscale image to (h, w): tile if too small,
        center-crop if too large. float32 [0, 1]."""
        tex = np.asarray(tex, np.float32)
        if tex.max() > 1.5:  # uint8-range input
            tex = tex / 255.0
        ry = -(-h // tex.shape[0])
        rx = -(-w // tex.shape[1])
        tiled = np.tile(tex, (ry, rx))
        y0 = (tiled.shape[0] - h) // 2
        x0 = (tiled.shape[1] - w) // 2
        return tiled[y0:y0 + h, x0:x0 + w].copy()

    @staticmethod
    def _texture(rng, h, w, cell):
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

    def object_velocity(self) -> float:
        """True lateral velocity in m/s."""
        return self.speed * self.z_obj / self.fx * self.fps

    def _paste(self, img: np.ndarray, y: int, x: int) -> None:
        """Draw the object at (y, x), clipped to the frame (the right-view
        position x - d_obj can be partially or fully off-frame at small
        widths / large disparities)."""
        y0, x0 = max(y, 0), max(x, 0)
        y1 = min(y + self.obj_h, self.h)
        x1 = min(x + self.obj_w, self.w)
        if y1 <= y0 or x1 <= x0:
            return
        img[y0:y1, x0:x1] = self.obj[y0 - y : y1 - y, x0 - x : x1 - x]

    def frame(self, k: int):
        obj_x = int(self.obj_x0 + self.speed * k)
        left = self.bg.copy()
        y, x = self.obj_y, obj_x
        self._paste(left, y, x)
        right = np.roll(self.bg, -int(round(self.d_bg)), axis=1)
        rx = x - int(round(self.d_obj))
        self._paste(right, y, rx)
        truth = {
            "obj_box": (y, x, self.obj_h, self.obj_w),
            "velocity": (self.object_velocity(), 0.0, 0.0),
            "z": self.z_obj,
        }
        return left, right, k / self.fps, truth

    def __iter__(self):
        for k in range(self.n_frames):
            left, right, t, _ = self.frame(k)
            yield left, right, t
