"""ctypes bindings for the native host runtime (native/framebuf.cpp).

Provides:
- :class:`NativeFrameRing` — contiguous-storage producer/consumer ring for
  decode/feed decoupling (a decoder thread pushes frames while the device
  feeder pops them).
- :class:`NativeY4MReader` — dependency-free YUV4MPEG2 file reader with C++
  YUV->BGR conversion.
- :class:`PrefetchingFileSource` — a FrameSource that runs any other source
  on a background thread through a NativeFrameRing, so host decode overlaps
  the device feed.

The shared library is not committed: each process builds it from
native/framebuf.cpp on first use with ``make -C native`` (a no-op while the
library is newer than its source).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from video_stabilization.io.video import FrameSource

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libframebuf.so"))
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    native_dir = os.path.abspath(_NATIVE_DIR)
    # one build at a time: parallel test workers share the checkout
    with open(os.path.join(native_dir, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_long]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.ring_pop.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.ring_size.restype = ctypes.c_int
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.ring_close.argtypes = [ctypes.c_void_p]
    lib.y4m_open.restype = ctypes.c_void_p
    lib.y4m_open.argtypes = [ctypes.c_char_p]
    lib.y4m_width.restype = ctypes.c_int
    lib.y4m_width.argtypes = [ctypes.c_void_p]
    lib.y4m_height.restype = ctypes.c_int
    lib.y4m_height.argtypes = [ctypes.c_void_p]
    lib.y4m_fps.restype = ctypes.c_double
    lib.y4m_fps.argtypes = [ctypes.c_void_p]
    lib.y4m_read_bgr.restype = ctypes.c_int
    lib.y4m_read_bgr.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.y4m_read_yuv.restype = ctypes.c_int
    lib.y4m_read_yuv.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.y4m_read_yuv_block.restype = ctypes.c_int
    lib.y4m_read_yuv_block.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.y4m_is_c420.restype = ctypes.c_int
    lib.y4m_is_c420.argtypes = [ctypes.c_void_p]
    lib.y4m_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeFrameRing:
    def __init__(self, capacity: int, frame_shape: Tuple[int, int, int]):
        self._lib = _load()
        self.frame_shape = frame_shape
        self.frame_bytes = int(np.prod(frame_shape))
        self._ring = self._lib.ring_create(capacity, self.frame_bytes)
        if not self._ring:
            raise RuntimeError("ring_create failed")

    def push(self, frame: np.ndarray, timeout_ms: int = -1) -> bool:
        buf = np.ascontiguousarray(frame, dtype=np.uint8)
        assert buf.nbytes == self.frame_bytes
        return bool(self._lib.ring_push(
            self._ring, buf.ctypes.data_as(ctypes.c_char_p), timeout_ms
        ))

    def pop(self, timeout_ms: int = -1) -> Optional[np.ndarray]:
        out = np.empty(self.frame_shape, np.uint8)
        ok = self._lib.ring_pop(
            self._ring, out.ctypes.data_as(ctypes.c_char_p), timeout_ms
        )
        return out if ok else None

    def size(self) -> int:
        return int(self._lib.ring_size(self._ring))

    def close(self) -> None:
        self._lib.ring_close(self._ring)

    def __del__(self):
        try:
            if getattr(self, "_ring", None):
                self._lib.ring_close(self._ring)
                self._lib.ring_destroy(self._ring)
                self._ring = None
        except Exception:
            pass


class NativeY4MReader(FrameSource):
    """Y4M file source decoded entirely in native code."""

    def __init__(self, path: str):
        self._lib = _load()
        self._r = self._lib.y4m_open(path.encode())
        if not self._r:
            raise RuntimeError(f"cannot open y4m file {path}")
        self.frame_size = (
            self._lib.y4m_height(self._r), self._lib.y4m_width(self._r)
        )
        self.fps = float(self._lib.y4m_fps(self._r)) or 30.0

    def read(self) -> Optional[np.ndarray]:
        h, w = self.frame_size
        out = np.empty((h, w, 3), np.uint8)
        ok = self._lib.y4m_read_bgr(self._r, out.ctypes.data_as(ctypes.c_char_p))
        return out if ok else None

    @property
    def is_c420(self) -> bool:
        return bool(self._lib.y4m_is_c420(self._r))

    @property
    def yuv_bytes(self) -> int:
        h, w = self.frame_size
        return h * w * 3 // 2 if self.is_c420 else h * w * 3

    def read_yuv(self) -> Optional[np.ndarray]:
        """One frame's raw packed Y|U|V planes (no host colorspace work) —
        pair with ops.image.yuv_planes_to_bgr on device."""
        out = np.empty((self.yuv_bytes,), np.uint8)
        ok = self._lib.y4m_read_yuv(self._r, out.ctypes.data_as(ctypes.c_char_p))
        return out if ok else None

    def read_yuv_block(self, k: int) -> Optional[np.ndarray]:
        """Up to ``k`` frames of raw packed Y|U|V planes as one contiguous
        (n, yuv_bytes) array — ONE native call per chunk.  The per-frame
        Python/FFI cost of ring pops + per-frame copies capped the
        single-core end-to-end streaming rate well below the device rate;
        block reads + async device dispatch restore the overlap with no
        producer thread at all.  Returns None at EOF."""
        out = np.empty((k, self.yuv_bytes), np.uint8)
        n = self._lib.y4m_read_yuv_block(
            self._r, out.ctypes.data_as(ctypes.c_char_p), k)
        if n == 0:
            return None
        return out[:n]

    def close(self) -> None:
        if self._r:
            self._lib.y4m_close(self._r)
            self._r = None


class PrefetchingYUVSource:
    """Background-thread raw-YUV prefetcher: a decode thread freads packed
    Y|U|V frames from a :class:`NativeY4MReader` into a native ring; ``read``
    pops flat uint8 plane buffers.  The host never touches pixel values —
    colorspace conversion happens on device (ops/image.py yuv_planes_to_bgr),
    so the per-frame host cost is fread + two memcpys."""

    def __init__(self, reader: NativeY4MReader, depth: int = 8):
        self.reader = reader
        self.frame_size = reader.frame_size
        self.is_c420 = reader.is_c420
        self.fps = reader.fps
        nbytes = reader.yuv_bytes
        self.ring = NativeFrameRing(depth, (nbytes,))
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while True:
            buf = self.reader.read_yuv()
            if buf is None:
                break
            if not self.ring.push(buf):
                break
        self.ring.close()

    def read(self) -> Optional[np.ndarray]:
        return self.ring.pop()

    def close(self) -> None:
        # Closing the ring makes the producer's next push fail; JOIN the
        # producer before freeing the native reader, otherwise y4m_close()
        # can run while the thread is still inside read_yuv()'s fread
        # (use-after-free when the consumer stops before EOF).
        self.ring.close()
        self._thread.join()
        self.reader.close()


class PrefetchingFileSource(FrameSource):
    """Wrap any FrameSource with a native ring + background decode thread."""

    def __init__(self, inner: FrameSource, depth: int = 8):
        self.inner = inner
        self.fps = inner.fps
        self.frame_size = inner.frame_size
        h, w = inner.frame_size
        self.ring = NativeFrameRing(depth, (h, w, 3))
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while True:
            frame = self.inner.read()
            if frame is None:
                break
            if not self.ring.push(frame):
                break
        self.ring.close()

    def read(self) -> Optional[np.ndarray]:
        return self.ring.pop()

    def close(self) -> None:
        # Same join-before-free ordering as PrefetchingYUVSource.close().
        self.ring.close()
        self._thread.join()
        self.inner.close()
