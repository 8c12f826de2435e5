"""Multi-stream batching and multi-chip sharding."""

from video_stabilization.parallel.streams import (  # noqa: F401
    init_batched_carry,
    make_batched_scan_fn,
    make_batched_step_fn,
    make_sharded_offline_fn,
    make_sharded_step_fn,
    make_stream_mesh,
)
