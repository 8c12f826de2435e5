"""Host-side video I/O and device feeding."""

from video_stabilization.io.video import (  # noqa: F401
    CameraSource,
    FileSource,
    FrameSource,
    SimulatorSource,
    VideoWriter,
    open_source,
)
