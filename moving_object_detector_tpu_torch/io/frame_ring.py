"""ctypes binding to the native SPSC frame ring (runtime/modt_runtime.cpp),
a copy of the JAX package's ``io/frame_ring.py`` (numpy only).

Loads ``runtime/libmodt_runtime.so`` where the repo root holds it and
exposes a numpy-friendly FrameRing. Falls back to a pure-Python
deque-based ring with identical semantics when the library is missing or
does not load, so the pipeline never hard-depends on the native build.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np

_RUNTIME_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "runtime",
)
_LIB_PATH = os.path.join(_RUNTIME_DIR, "libmodt_runtime.so")

_lib = None
_lib_lock = threading.Lock()


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.modt_ring_create.restype = ctypes.c_void_p
        lib.modt_ring_create.argtypes = [
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_int,
        ]
        lib.modt_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.modt_ring_size.restype = ctypes.c_size_t
        lib.modt_ring_size.argtypes = [ctypes.c_void_p]
        lib.modt_ring_dropped.restype = ctypes.c_uint64
        lib.modt_ring_dropped.argtypes = [ctypes.c_void_p]
        lib.modt_ring_push.restype = ctypes.c_int
        lib.modt_ring_push.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.c_double,
        ]
        lib.modt_ring_pop.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.modt_ring_pop.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_double,
        ]
        lib.modt_ring_release.argtypes = [ctypes.c_void_p]
        try:
            lib.modt_ring_pop_copy.restype = ctypes.c_int
            lib.modt_ring_pop_copy.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_double,
            ]
        except AttributeError:
            pass  # prebuilt lib predates the validated-copy entry point
        try:
            lib.modt_png_defilter.restype = ctypes.c_int
            lib.modt_png_defilter.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_size_t,
                ctypes.c_size_t,
                ctypes.c_size_t,
            ]
        except AttributeError:
            pass  # prebuilt lib predates the defilter entry point
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def png_defilter(
    raw: bytes, height: int, stride: int, bpp: int
) -> Optional[np.ndarray]:
    """Native PNG scanline reconstruction (readers.read_png hot path):
    (height*(stride+1)) inflated bytes -> (height, stride) u8, or None if
    the native runtime is unavailable (caller falls back to Python)."""
    lib = _load_library()
    if lib is None or not hasattr(lib, "modt_png_defilter"):
        return None
    out = np.empty((height, stride), np.uint8)
    rc = lib.modt_png_defilter(
        raw,
        len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height,
        stride,
        bpp,
    )
    return out if rc == 0 else None


class FrameRing:
    """SPSC ring of stereo frames. Producer: ``push(left, right, t)``;
    consumer: ``pop() -> (left, right, t) | None``.

    drop_oldest=True mirrors the reference's queue_size=1 latest-wins
    subscriptions; False gives blocking backpressure. ``dropped()``
    counts the pairs pushed out to make room. Each push is stamped by its
    sequence number as it begins (``time.perf_counter_ns``), and a pop
    leaves its pair's stamp in ``pushed_ns`` (None where a later push has
    reused the slot).
    """

    def __init__(
        self,
        height: int,
        width: int,
        capacity: int = 4,
        drop_oldest: bool = False,
        force_python: bool = False,
        channels: int = 1,
    ):
        self.h, self.w = height, width
        self.channels = channels
        self._frame_shape = (
            (height, width) if channels == 1 else (height, width, channels)
        )
        self._frame_px = height * width * channels
        self.frame_floats = 2 * self._frame_px
        self.payload_bytes = self.frame_floats * 4
        self._drop_oldest = drop_oldest
        self._lib = None if force_python else _load_library()
        if (
            self._lib is not None
            and drop_oldest
            and not hasattr(self._lib, "modt_ring_pop_copy")
        ):
            # Drop-oldest needs the validated-copy pop: the zero-copy
            # pop/release protocol races the producer's tail advance.
            self._lib = None
        if self._lib is not None:
            self._ring = self._lib.modt_ring_create(
                capacity, self.payload_bytes, 1 if drop_oldest else 0
            )
            if not self._ring:
                raise RuntimeError("ring allocation failed")
        else:
            self._ring = None
            self._deque: collections.deque = collections.deque(maxlen=capacity if drop_oldest else None)
            self._capacity = capacity
            self._drop_oldest = drop_oldest
            self._cond = threading.Condition()
        self._seq = 0
        self._dropped = 0
        # (seq, ns) by seq % (capacity + 1): a popped pair's slot is not
        # reused before its pop, the ring holding at most ``capacity``.
        self._stamps: list = [(-1, 0)] * (capacity + 1)
        self.pushed_ns: Optional[int] = None

    # -- producer -----------------------------------------------------------
    def push(self, left: np.ndarray, right: np.ndarray, t: float,
             timeout: float = 5.0) -> bool:
        buf = np.concatenate(
            [
                np.ascontiguousarray(left, np.float32).reshape(-1),
                np.ascontiguousarray(right, np.float32).reshape(-1),
            ]
        )
        if buf.size != self.frame_floats:
            raise ValueError(
                f"frame pair of {buf.size} values does not fit the ring's "
                f"{self._frame_shape} frames")
        self._stamps[self._seq % len(self._stamps)] = (
            self._seq, time.perf_counter_ns())
        if self._ring is not None:
            ok = self._lib.modt_ring_push(
                self._ring, buf.tobytes(), float(t), self._seq, timeout
            )
            self._seq += 1
            return bool(ok)
        with self._cond:
            if not self._drop_oldest:
                deadline = timeout
                while len(self._deque) >= self._capacity:
                    if not self._cond.wait(timeout=deadline):
                        return False
            elif len(self._deque) == self._deque.maxlen:
                self._dropped += 1  # the append pushes the oldest out
            self._deque.append((buf, float(t), self._seq))
            self._seq += 1
            self._cond.notify_all()
            return True

    # -- consumer -----------------------------------------------------------
    def pop(self, timeout: float = 5.0):
        if self._ring is not None:
            ts = ctypes.c_double()
            seq = ctypes.c_int64()
            if self._drop_oldest:
                # Validated copy: the producer may reclaim the oldest slot
                # mid-read in latest-wins mode, so zero-copy views are
                # unsafe — the kernel copies and CAS-claims atomically.
                buf = np.empty(self.payload_bytes, np.uint8)
                ok = self._lib.modt_ring_pop_copy(
                    self._ring,
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.byref(ts),
                    ctypes.byref(seq),
                    timeout,
                )
                if not ok:
                    return None
                frames = buf.view(np.float32)[: self.frame_floats]
            else:
                ptr = self._lib.modt_ring_pop(
                    self._ring, ctypes.byref(ts), ctypes.byref(seq), timeout
                )
                if not ptr:
                    return None
                flat = np.ctypeslib.as_array(
                    ptr, shape=(self.payload_bytes,)
                )
                frames = flat.view(np.float32)[: self.frame_floats].copy()
                self._lib.modt_ring_release(self._ring)
            self._popped(seq.value)
            left = frames[: self._frame_px].reshape(self._frame_shape)
            right = frames[self._frame_px :].reshape(self._frame_shape)
            return left, right, float(ts.value)
        with self._cond:
            if not self._deque:
                if not self._cond.wait(timeout=timeout):
                    return None
            if not self._deque:
                return None
            buf, t, seq = self._deque.popleft()
            self._cond.notify_all()
        self._popped(seq)
        left = buf[: self._frame_px].reshape(self._frame_shape)
        right = buf[self._frame_px :].reshape(self._frame_shape)
        return left, right, t

    def _popped(self, seq: int) -> None:
        stamp_seq, ns = self._stamps[seq % len(self._stamps)]
        self.pushed_ns = ns if stamp_seq == seq else None

    def size(self) -> int:
        if self._ring is not None:
            return int(self._lib.modt_ring_size(self._ring))
        return len(self._deque)

    def dropped(self) -> int:
        if self._ring is not None:
            return int(self._lib.modt_ring_dropped(self._ring))
        return self._dropped

    def close(self):
        if self._ring is not None:
            self._lib.modt_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
