"""Stream-parallel execution: vmap on one device, sharded meshes across devices.

The reference is strictly single-stream, single-thread (SURVEY.md §2.5); its
only parallelism is OpenCV's internal row-threading.  The scaling model
(SURVEY.md §5.8, BASELINE config 5) is:

- **per device**: ``vmap`` the per-frame step over a batch of independent
  video streams — one fused program where every kernel (pyramids, LK,
  RANSAC, warp) processes all streams' data together, at depths a single
  360p stream cannot fill.
- **across devices**: shard the stream axis of both the carry and the frame
  batch over a 1-D device mesh with ``jax.sharding``.  Streams never
  interact, so XLA inserts **zero collectives** in the steady state — only
  metrics aggregation (e.g. mean inlier counts) would ever cross devices.

Because the carry is an explicit pytree, sharding it is one
``NamedSharding`` over the leading axis — no per-rank state objects and no
communicators to manage.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Sequence

import jax

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from video_stabilization.config import StabilizerConfig
from video_stabilization.engine.state import EngineCarry, init_carry
from video_stabilization.engine.stabilizer import stabilize_step

STREAM_AXIS = "streams"

_warned_dynamic_vmap = False


def _warn_if_dynamic_mode(config: StabilizerConfig, fn_name: str) -> None:
    """Batching the dynamic-mode step runs EVERY lock branch per stream
    (vmap turns lax.switch into an all-branches select, ~5x the step cost).
    Warn once instead of raising: the result is correct, just slow."""
    global _warned_dynamic_vmap
    if config.static_mode is None and not _warned_dynamic_vmap:
        _warned_dynamic_vmap = True
        warnings.warn(
            f"{fn_name}: config.static_mode is None — under vmap the "
            "runtime mode switch evaluates every lock branch (accumulated + "
            "ORB + SIFT) for every stream on every frame. Pin the mode at "
            "trace time (dataclasses.replace(config, static_mode="
            "int(StabilizationMode.X))) for batched throughput.",
            stacklevel=3,
        )


def init_batched_carry(
    config: StabilizerConfig, n_streams: int, mode: int, key: jax.Array
) -> EngineCarry:
    """Carry pytree with a leading (n_streams,) axis on every leaf."""
    keys = jax.random.split(key, n_streams)
    return jax.vmap(lambda k: init_carry(config, mode, k))(keys)


@functools.lru_cache(maxsize=32)
def make_batched_step_fn(config: StabilizerConfig) -> Callable:
    """(carry_batch, frames (S,Hf,Wf,C)) -> (carry_batch, (outputs, valid)) —
    jitted vmap over streams for single-chip throughput."""
    _warn_if_dynamic_mode(config, "make_batched_step_fn")
    step = functools.partial(stabilize_step, config=config)
    # carry donated: in-place frame-ring updates (see engine.make_step_fn)
    return jax.jit(jax.vmap(step), donate_argnums=0)


@functools.lru_cache(maxsize=32)
def make_batched_scan_fn(config: StabilizerConfig) -> Callable:
    """(carry_batch, frames (T, S, Hf, Wf, C)) -> (carry_batch, (outputs,
    valid)) — ``lax.scan`` over frames of the vmapped per-stream step.  One
    dispatch stabilizes a whole clip for every stream on the chip (the
    single-chip throughput path; see ``engine.make_scan_fn``)."""
    _warn_if_dynamic_mode(config, "make_batched_scan_fn")
    step = functools.partial(stabilize_step, config=config)
    vstep = jax.vmap(step)

    def scan_fn(carry, frames):
        return jax.lax.scan(vstep, carry, frames)

    return jax.jit(scan_fn, donate_argnums=0)


def make_stream_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """1-D mesh over all (or the given) devices along the stream axis."""
    devs = list(devices) if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.array(devs), (STREAM_AXIS,))


def make_sharded_step_fn(config: StabilizerConfig, mesh: Mesh) -> Callable:
    """Multi-chip step: streams sharded over the mesh's ``streams`` axis.

    Carry leaves and the frame batch are all partitioned on their leading
    stream axis; outputs come back with the same sharding so the carry never
    leaves the devices between frames.
    """
    _warn_if_dynamic_mode(config, "make_sharded_step_fn")
    step = functools.partial(stabilize_step, config=config)
    vstep = jax.vmap(step)

    stream_sharding = NamedSharding(mesh, P(STREAM_AXIS))

    def shard_tree(tree):
        return jax.tree.map(lambda _: stream_sharding, tree)

    # The carry is a pytree: every leaf gets stream-axis sharding. jit infers
    # output shardings to match (stream-pure computation => no resharding).
    def sharded_step(carry, frames):
        carry = jax.lax.with_sharding_constraint(carry, shard_tree(carry))
        frames = jax.lax.with_sharding_constraint(frames, stream_sharding)
        return vstep(carry, frames)

    return jax.jit(sharded_step, donate_argnums=0)


def shard_carry(carry: EngineCarry, mesh: Mesh) -> EngineCarry:
    """Place a batched carry onto the mesh, stream-sharded."""
    sharding = NamedSharding(mesh, P(STREAM_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), carry)


def make_sharded_offline_fn(config: StabilizerConfig, mesh: Mesh) -> Callable:
    """Multi-chip offline throughput: (carry_batch, frames (S, K, Hf, Wf, C))
    -> (carry_batch, (outputs, valid)) with streams sharded over the mesh and
    the K-frame chunk batched per stream (engine/offline.py).  Streams never
    interact, so the steady state needs zero collectives; each chip runs the
    fully batched per-chunk pipeline on its stream shard."""
    from video_stabilization.engine.offline import offline_chunk_step

    if config.static_mode is None:
        raise ValueError("sharded offline pipeline requires config.static_mode")
    vstep = jax.vmap(functools.partial(offline_chunk_step, config=config))

    stream_sharding = NamedSharding(mesh, P(STREAM_AXIS))

    def sharded_step(carry, frames):
        carry = jax.lax.with_sharding_constraint(
            carry, jax.tree.map(lambda _: stream_sharding, carry))
        frames = jax.lax.with_sharding_constraint(frames, stream_sharding)
        return vstep(carry, frames)

    return jax.jit(sharded_step, donate_argnums=0)
