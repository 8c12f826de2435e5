"""The stabilization engine: carry pytree, per-frame step function, modes."""

from video_stabilization.engine.state import EngineCarry, init_carry  # noqa: F401
from video_stabilization.engine.smoothing import smoothing_homography  # noqa: F401
from video_stabilization.engine.stabilizer import (  # noqa: F401
    Stabilizer,
    make_scan_fn,
    make_step_fn,
    stabilize_step,
)
from video_stabilization.engine.offline import (  # noqa: F401
    make_offline_batched_fn,
    make_offline_fn,
    offline_chunk_step,
    stabilize_clip_offline,
)
