"""Utilities: timing/profiling, logging."""

from video_stabilization.utils.timing import honest_time, StageTimer  # noqa: F401
