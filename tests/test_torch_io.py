"""The port's host I/O (readers, viz, frame ring) against the JAX
package's: the same files and seeds must give byte-equal results, and the
ring must keep its blocking and drop-oldest semantics."""

import os
import struct
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moving_object_detector_tpu.io import readers as jreaders
from moving_object_detector_tpu.io import viz as jviz
from moving_object_detector_tpu.types import MovingObjects as JObjects
from moving_object_detector_tpu_torch.io import readers, viz
from moving_object_detector_tpu_torch.io.frame_ring import (
    FrameRing,
    native_available,
)
from moving_object_detector_tpu_torch.types import MovingObjects


def _write_png(path, arr, bitdepth=8, color=False, filt=0):
    h, w = arr.shape[:2]
    raw = bytearray()
    prev = None
    for y in range(h):
        row = (arr[y].astype(">u2") if bitdepth == 16
               else arr[y].astype(np.uint8)).tobytes()
        line = np.frombuffer(row, np.uint8).astype(np.int32)
        if filt == 2 and prev is not None:  # Up
            enc = (line - prev) & 0xFF
        else:
            enc = line
        raw.append(2 if filt == 2 and prev is not None else 0)
        raw.extend(enc.astype(np.uint8).tobytes())
        prev = line

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data))

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, 2 if color else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["pgm", "ppm", "png8", "png16", "png_rgb",
                                  "png_up", "npy"])
@pytest.mark.parametrize("color", [False, True])
def test_read_image_byte_equal(tmp_path, kind, color):
    rng = np.random.default_rng(len(kind))
    if kind == "pgm":
        img = rng.integers(0, 256, (6, 8)).astype(np.uint8)
        path = tmp_path / "a.pgm"
        path.write_bytes(b"P5\n# made by a test\n8 6\n255\n" + img.tobytes())
    elif kind == "ppm":
        img = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
        path = tmp_path / "a.ppm"
        path.write_bytes(b"P6\n7 5\n255\n" + img.tobytes())
    elif kind == "npy":
        path = tmp_path / "a.npy"
        np.save(path, rng.integers(0, 256, (6, 9)).astype(np.uint8))
    else:
        path = tmp_path / "a.png"
        if kind == "png16":
            _write_png(path, rng.integers(0, 65536, (9, 11)).astype(np.uint16),
                       bitdepth=16)
        elif kind == "png_rgb":
            _write_png(path, rng.integers(0, 256, (7, 5, 3)).astype(np.uint8),
                       color=True)
        else:
            _write_png(path, rng.integers(0, 256, (12, 17)).astype(np.uint8),
                       filt=2 if kind == "png_up" else 0)
    out = readers.read_image(str(path), color=color)
    ref = jreaders.read_image(str(path), color=color)
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape
    assert out.tobytes() == ref.tobytes()


def _assert_sequences_equal(a, b, n):
    fa, fb = list(a), list(b)
    assert len(fa) == len(fb) == n
    for (l1, r1, t1), (l2, r2, t2) in zip(fa, fb):
        assert l1.dtype == l2.dtype and l1.tobytes() == l2.tobytes()
        assert r1.tobytes() == r2.tobytes() and t1 == t2


@pytest.mark.parametrize("color", [False, True])
def test_npz_sequence_byte_equal(tmp_path, color):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "seq.npz")
    np.savez(path, left=rng.uniform(size=(3, 6, 8, 3)).astype(np.float32),
             right=rng.uniform(size=(3, 6, 8, 3)).astype(np.float32),
             time=np.array([0.0, 0.1, 0.25]))
    _assert_sequences_equal(readers.NpzSequence(path, color=color),
                            jreaders.NpzSequence(path, color=color), 3)


def test_image_sequence_with_timestamps_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    for side in ("image_02", "image_03"):
        os.makedirs(tmp_path / side / "data")
        for k in range(3):
            _write_png(tmp_path / side / "data" / f"{k:010d}.png",
                       rng.integers(0, 256, (8, 12)).astype(np.uint8))
    (tmp_path / "image_02" / "timestamps.txt").write_text(
        "2011-09-26 13:02:25.594360375\n2011-09-26 13:02:25.697842750\n"
        "2011-09-26 13:02:25.801200500\n")
    dirs = (str(tmp_path / "image_02" / "data"),
            str(tmp_path / "image_03" / "data"))
    _assert_sequences_equal(readers.ImageSequence(*dirs),
                            jreaders.ImageSequence(*dirs), 3)


@pytest.mark.parametrize("kw", [
    dict(height=64, width=128, fx=100.0, baseline=0.48, z_bg=8.0, z_obj=4.0,
         obj_size=(24, 30), obj_speed_px=5.0, n_frames=3, seed=0),
    dict(height=48, width=90, fx=60.0, baseline=0.3, n_frames=2, seed=7),
], ids=["block", "defaults"])
def test_synthetic_sequence_byte_equal(kw):
    a = readers.SyntheticStereoSequence(**kw)
    b = jreaders.SyntheticStereoSequence(**kw)
    _assert_sequences_equal(a, b, kw["n_frames"])
    assert a.object_velocity() == b.object_velocity()
    assert a.frame(1)[3] == b.frame(1)[3]


def test_socket_sequence_roundtrip():
    import socket

    rng = np.random.default_rng(2)
    frames = [(rng.uniform(size=(6, 8)).astype(np.float32),
               rng.uniform(size=(6, 8)).astype(np.float32), 0.1 * k)
              for k in range(3)]
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port = server.getsockname()[1]

    def serve():
        conn, _ = server.accept()
        with conn:
            for left, right, t in frames:
                readers.write_socket_frame(conn, left, right, t)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    got = list(readers.SocketStereoSequence("127.0.0.1", port,
                                            idle_timeout=5.0))
    th.join(timeout=5.0)
    server.close()
    assert len(got) == 3
    for (left, _, t), (gl, _, gt) in zip(frames, got):
        np.testing.assert_allclose(gl, left, atol=0.5 / 255 + 1e-6)
        assert gt == pytest.approx(t)


def test_viz_products_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    labels = rng.integers(-1, 4, (9, 13)).astype(np.int32)
    flow = rng.normal(0, 3, (9, 13, 2)).astype(np.float32)
    flow[0, 0] = np.nan
    cloud = rng.normal(0, 5, (9, 13, 3)).astype(np.float32)
    cloud[2, 3] = np.nan
    for name, args in (("colorize_labels", (labels, 4)),
                       ("flow_to_rgb", (flow,)),
                       ("velocity_image", (cloud, 2.0)),
                       ("depth_image", (cloud,)),
                       ("label_colors", (5,)),
                       ("png_bytes", (np.abs(flow[..., 0]) / 9,))):
        out, ref = getattr(viz, name)(*args), getattr(jviz, name)(*args)
        if isinstance(out, bytes):
            assert out == ref, name
        else:
            assert out.dtype == ref.dtype and out.tobytes() == ref.tobytes(), \
                name
    for mod, sub in ((viz, "t"), (jviz, "j")):
        os.makedirs(tmp_path / sub)
        mod.write_ppm(str(tmp_path / sub / "a.ppm"), np.abs(flow[..., 0]) / 9)
        mod.write_png(str(tmp_path / sub / "a.png"), viz.flow_to_rgb(flow))
        mod.write_ply(str(tmp_path / sub / "a.ply"), cloud, cloud * 0.1)
    for name in ("a.ppm", "a.png", "a.ply"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_markers_from_tensors_equal_the_jax_markers(tmp_path):
    ids = np.array([7, -1, 3, -1], np.int32)
    valid = ids >= 0
    rng = np.random.default_rng(4)
    c, v, b = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3))
    tobj = MovingObjects(id=torch.from_numpy(ids), center=torch.from_numpy(c),
                         velocity=torch.from_numpy(v),
                         bounding_box=torch.from_numpy(b),
                         valid=torch.from_numpy(valid))
    jobj = JObjects(id=jnp.asarray(ids), center=jnp.asarray(c),
                    velocity=jnp.asarray(v), bounding_box=jnp.asarray(b),
                    valid=jnp.asarray(valid))
    out = viz.objects_to_markers(tobj, frame_id="odom", color=(0, 1, 0, 0.8))
    ref = jviz.objects_to_markers(jobj, frame_id="odom", color=(0, 1, 0, 0.8))
    assert out == ref and len(out) == 5
    viz.write_marker_json(str(tmp_path / "t.json"), out)
    jviz.write_marker_json(str(tmp_path / "j.json"), ref)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def _ring(force_python, **kw):
    if not force_python and not native_available():
        pytest.skip("native runtime unavailable")
    return FrameRing(force_python=force_python, **kw)


@pytest.mark.parametrize("force_python", [True, False])
@pytest.mark.parametrize("channels", [1, 3])
def test_frame_ring_roundtrip_in_order(force_python, channels):
    ring = _ring(force_python, height=8, width=10, capacity=3,
                 channels=channels)
    shape = (8, 10) if channels == 1 else (8, 10, 3)
    rng = np.random.default_rng(0)
    frames = [(rng.uniform(size=shape).astype(np.float32),
               rng.uniform(size=shape).astype(np.float32), 0.1 * i)
              for i in range(7)]
    out = []

    def consumer():
        for _ in frames:
            out.append(ring.pop(timeout=5.0))

    th = threading.Thread(target=consumer)
    th.start()
    for left, right, t in frames:
        assert ring.push(left, right, t, timeout=5.0)
    th.join(timeout=10.0)
    assert len(out) == 7 and all(o is not None for o in out)
    for (left, right, t), (ol, orr, ot) in zip(frames, out):
        assert ol.tobytes() == left.tobytes()
        assert orr.tobytes() == right.tobytes()
        assert ot == pytest.approx(t, abs=1e-12)
    ring.close()


@pytest.mark.parametrize("force_python", [True, False])
def test_frame_ring_blocks_when_full_and_empty(force_python):
    ring = _ring(force_python, height=4, width=4, capacity=2)
    a = np.zeros((4, 4), np.float32)
    assert ring.pop(timeout=0.05) is None  # empty: times out
    assert ring.push(a, a, 0.0, timeout=0.1)
    assert ring.push(a + 1, a, 1.0, timeout=0.1)
    assert ring.size() == 2
    t0 = time.perf_counter()
    assert not ring.push(a + 2, a, 2.0, timeout=0.2)  # full: backpressure
    assert time.perf_counter() - t0 >= 0.15
    assert ring.dropped() == 0
    got = ring.pop(timeout=1.0)
    assert got[2] == 0.0 and got[0][0, 0] == 0.0  # the oldest, untouched
    assert ring.push(a + 2, a, 2.0, timeout=0.2)  # room again
    assert [ring.pop(timeout=1.0)[2] for _ in range(2)] == [1.0, 2.0]
    ring.close()


@pytest.mark.parametrize("force_python", [True, False])
def test_frame_ring_drop_oldest_keeps_the_newest(force_python):
    ring = _ring(force_python, height=4, width=4, capacity=2,
                 drop_oldest=True)
    a = np.zeros((4, 4), np.float32)
    for i in range(5):
        assert ring.push(a + i, a, float(i), timeout=0.1)  # never blocks
    assert ring.size() <= 2
    got = []
    while (item := ring.pop(timeout=0.05)) is not None:
        got.append(item)
    assert got and got[-1][2] == 4.0 and got[-1][0][0, 0] == 4.0
    assert all(g[2] >= 2.0 for g in got)
    assert [g[2] for g in got] == sorted(g[2] for g in got)
    ring.close()


@pytest.mark.parametrize("force_python", [True, False])
def test_frame_ring_refuses_a_frame_of_another_size(force_python):
    """A smaller frame would make the native ring copy past its end."""
    ring = _ring(force_python, height=8, width=10, capacity=2)
    small = np.zeros((4, 10), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        ring.push(small, small, 0.0)
    ring.close()
