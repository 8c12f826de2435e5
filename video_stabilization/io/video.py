"""Frame sources and sinks.

Mirrors the reference's input plumbing (src/main_utils.cpp:238-298):

- :class:`CameraSource` — webcam via cv2.VideoCapture, requests 1280x720,
  fps fallback 30 (reference :243-260).
- :class:`FileSource` — video file via cv2.VideoCapture, fps fallback 30,
  EOF handling (reference :262-281, :397-417).
- :class:`SimulatorSource` — the JAX floor-texture camera simulator with the
  reference demo app's start pose and movement/roll controls, fixed 30 fps
  (reference :283-295; src/main.cpp:29-36).
- :class:`VideoWriter` — file sink (mp4/avi via cv2, .y4m via a dependency-
  free writer) for headless operation, which the reference (GUI-only) lacks.

All sources produce (H, W, 3) uint8 BGR numpy frames; the engine feeder is
responsible for staging them on device (see cli.app).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


class FrameSource:
    """Abstract frame source."""

    fps: float = 30.0
    frame_size: Tuple[int, int] = (720, 1280)    # (H, W)

    def read(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CameraSource(FrameSource):
    def __init__(self, camera_id: int = 0):
        if not _HAS_CV2:
            raise RuntimeError("OpenCV required for camera capture")
        self.cap = cv2.VideoCapture(camera_id)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera {camera_id}")
        # request 1280x720 like the reference (src/main_utils.cpp:245-246)
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, 1280)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 720)
        fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.fps = fps if fps and fps > 0 else 30.0
        ok, frame = self.cap.read()
        if not ok:
            raise RuntimeError("camera produced no frames")
        self.frame_size = frame.shape[:2]
        self._first = frame

    def read(self):
        if self._first is not None:
            f, self._first = self._first, None
            return f
        ok, frame = self.cap.read()
        return frame if ok else None

    def close(self):
        self.cap.release()


class FileSource(FrameSource):
    def __init__(self, path: str):
        if not _HAS_CV2:
            raise RuntimeError("OpenCV required for file decode")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open video file {path}")
        fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.fps = fps if fps and fps > 0 else 30.0
        self.frame_size = (
            int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        )

    def read(self):
        ok, frame = self.cap.read()
        return frame if ok else None           # None = EOF (reference :397-417)

    def close(self):
        self.cap.release()


class SimulatorSource(FrameSource):
    """JAX camera-engine source with interactive pose control.

    The reference's CameraEngine + default_camera_params
    (src/main.cpp:29-36: pos (0.5, -0.3, 0.7), pan 0, tilt 180, roll 180).
    """

    def __init__(self, texture_path: Optional[str] = None,
                 frame_size: Tuple[int, int] = (720, 1280), seed: int = 0):
        import jax

        from video_stabilization.sim import (
            DEFAULT_APP_PARAMS,
            make_default_texture,
        )
        from video_stabilization.sim.camera_engine import render_frame

        self.fps = 30.0                        # reference: fixed 30 (:292)
        self.frame_size = frame_size
        if texture_path is not None:
            if not _HAS_CV2:
                raise RuntimeError("OpenCV required to load a texture file")
            tex = cv2.imread(texture_path)
            if tex is None:
                raise RuntimeError(f"could not load floor texture '{texture_path}'")
            self.texture = np.ascontiguousarray(tex)
        else:
            self.texture = np.asarray(make_default_texture(jax.random.key(seed)))
        self.params = DEFAULT_APP_PARAMS
        h, w = frame_size
        # texture passed as an argument — never a jit closure capture
        self._render = jax.jit(lambda t, p: render_frame(t, p, h, w))

    # movement controls (reference: src/main_utils.cpp:327-369)
    def move(self, key: str, amount: float = 1.0) -> None:
        from video_stabilization.sim import (
            DEFAULT_APP_PARAMS,
            move_backward, move_down, move_forward, move_left, move_right,
            move_up, roll_clockwise, roll_counterclockwise,
        )

        actions = {
            "w": move_forward, "s": move_backward,
            "a": move_left, "d": move_right,
            " ": move_up, "c": move_down,
        }
        if key in actions:
            self.params = actions[key](self.params, amount)
        elif key == "q":
            self.params = roll_counterclockwise(self.params, amount)
        elif key == "e":
            self.params = roll_clockwise(self.params, amount)
        elif key == "p":
            self.params = DEFAULT_APP_PARAMS   # reset pose

    def read(self):
        return np.asarray(self._render(self.texture, self.params))

    def pose_text(self) -> list[str]:
        """On-frame pose overlay lines (reference: src/main_utils.cpp:421-448)."""
        p = self.params
        pos = np.asarray(p.position)
        return [
            f"pos: ({pos[0]:+.2f}, {pos[1]:+.2f}, {pos[2]:+.2f})",
            f"pan: {float(p.pan):+.1f}  tilt: {float(p.tilt):+.1f}  "
            f"roll: {float(p.roll):+.1f}",
        ]


class VideoWriter:
    """Frame sink: mp4/avi via cv2, or dependency-free .y4m."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 subsampling: str = "444"):
        self.path = path
        self.fps = fps
        self.h, self.w = frame_size
        self._y4m = path.endswith(".y4m")
        self._c420 = subsampling == "420"
        if self._c420 and (self.h % 2 or self.w % 2):
            raise ValueError("C420 output needs even frame dimensions")
        if self._y4m:
            self._f = open(path, "wb")
            chroma = "420" if self._c420 else "444"
            hdr = (f"YUV4MPEG2 W{self.w} H{self.h} F{int(round(fps))}:1 "
                   f"Ip A1:1 C{chroma}\n")
            self._f.write(hdr.encode())
        else:
            if not _HAS_CV2:
                raise RuntimeError("OpenCV required for non-y4m output")
            fourcc = cv2.VideoWriter_fourcc(*("mp4v" if path.endswith(".mp4") else "XVID"))
            self._vw = cv2.VideoWriter(path, fourcc, fps, (self.w, self.h))

    def write(self, frame_bgr: np.ndarray) -> None:
        if self._y4m:
            f = frame_bgr.astype(np.float32)
            b, g, r = f[..., 0], f[..., 1], f[..., 2]
            y = 0.299 * r + 0.587 * g + 0.114 * b
            u = 128.0 + 0.564 * (b - y)
            v = 128.0 + 0.713 * (r - y)
            if self._c420:
                # 2x2 box-average chroma (the native reader upsamples by
                # nearest-repeat, native/framebuf.cpp y4m_read_bgr)
                u = u.reshape(self.h // 2, 2, self.w // 2, 2).mean(axis=(1, 3))
                v = v.reshape(self.h // 2, 2, self.w // 2, 2).mean(axis=(1, 3))
            self._f.write(b"FRAME\n")
            for plane in (y, u, v):
                self._f.write(np.clip(plane, 0, 255).astype(np.uint8).tobytes())
        else:
            self._vw.write(frame_bgr)

    def close(self) -> None:
        if self._y4m:
            self._f.close()
        else:
            self._vw.release()


def open_source(mode: str, *, path: Optional[str] = None,
                camera_id: int = 0, texture: Optional[str] = None,
                frame_size: Tuple[int, int] = (720, 1280)) -> FrameSource:
    """Input-source factory (reference: initializeInputSource,
    src/main_utils.cpp:238-298)."""
    if mode == "camera":
        return CameraSource(camera_id)
    if mode == "file":
        return FileSource(path)
    if mode == "simulator":
        return SimulatorSource(texture, frame_size)
    raise ValueError(f"unknown input mode {mode!r}")
