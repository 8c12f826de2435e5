"""Motion-model families for inter-frame registration."""

from video_stabilization.models.motion_models import (  # noqa: F401
    MotionModel,
    fit_homography_dlt,
    fit_motion,
)
