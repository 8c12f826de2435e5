"""Scripted camera trajectories + procedural floor texture.

The reference's CameraEngine is driven interactively by keyboard
(src/main_utils.cpp:327-369); its purpose is "precise, repeatable, and fully
controllable camera movements" for debugging (include/camera_engine.hpp:31-33).
Here trajectories are first-class data: a function from a PRNG key to a
batched :class:`CameraParams` sequence, so tests and benchmarks generate
deterministic shaky footage — with exact analytic inter-frame homographies —
entirely on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from video_stabilization.sim.camera_engine import CameraParams


def make_default_texture(key: jax.Array, size: int = 512) -> jax.Array:
    """Procedural corner-rich floor texture, (size, size, 3) uint8 BGR.

    The reference loads a photo from disk (src/camera_engine.cpp:10); for a
    hermetic test fixture we synthesize one: a coarse random color mosaic
    (strong corners for GFTT/FAST at every cell boundary) overlaid with a
    fine checker and a smooth gradient so that every scale has structure.
    """
    k1, k2 = jax.random.split(key)
    cells = 16
    mosaic = jax.random.uniform(k1, (cells, cells, 3), minval=0.15, maxval=0.95)
    up = size // cells
    mosaic = jnp.repeat(jnp.repeat(mosaic, up, axis=0), up, axis=1)

    ys = jnp.arange(size)[:, None]
    xs = jnp.arange(size)[None, :]
    checker = (((ys // 8) + (xs // 8)) % 2).astype(jnp.float32) * 0.12
    grad = (xs / size * 0.15 + ys / size * 0.1).astype(jnp.float32)

    noise = jax.random.uniform(k2, (size, size, 1), minval=-0.05, maxval=0.05)
    img = jnp.clip(mosaic + checker[..., None] + grad[..., None] + noise, 0.0, 1.0)
    return (img * 255.0).astype(jnp.uint8)


def shake_trajectory(
    key: jax.Array,
    n_frames: int,
    base: CameraParams,
    pos_amplitude: float = 0.02,
    roll_amplitude: float = 1.0,
    smoothness: float = 0.8,
) -> CameraParams:
    """Random-walk handheld shake around a base pose.

    Returns a :class:`CameraParams` pytree with a leading (n_frames,) axis.
    The shake is an AR(1) (Ornstein-Uhlenbeck-like) process: bounded,
    zero-mean jitter in position and roll — the motion profile the
    GLOBAL_SMOOTHING mode is designed to remove.
    """
    kp, kr = jax.random.split(key)
    pos_noise = jax.random.normal(kp, (n_frames, 3)) * pos_amplitude
    roll_noise = jax.random.normal(kr, (n_frames,)) * roll_amplitude

    def ar1(carry, x):
        y = smoothness * carry + (1.0 - smoothness) * x
        return y, y

    _, pos_off = jax.lax.scan(ar1, jnp.zeros(3), pos_noise)
    _, roll_off = jax.lax.scan(ar1, jnp.zeros(()), roll_noise)

    n = n_frames
    return CameraParams(
        position=base.position[None, :] + pos_off,
        pan=jnp.broadcast_to(base.pan, (n,)),
        tilt=jnp.broadcast_to(base.tilt, (n,)),
        roll=base.roll + roll_off,
        focal_length=jnp.broadcast_to(base.focal_length, (n,)),
    )


def smooth_pan_trajectory(
    key: jax.Array,
    n_frames: int,
    base: CameraParams,
    pan_per_frame: float = 0.1,
    shake_pos: float = 0.01,
    shake_roll: float = 0.5,
) -> CameraParams:
    """Intentional slow lateral drift + handheld shake on top.

    Global smoothing should preserve the drift while suppressing the shake —
    the core behavioral contract of the smoothing mode
    (docs/math-overview.md "reduces unwanted shake while preserving
    intentional movement").
    """
    shaken = shake_trajectory(
        key, n_frames, base, pos_amplitude=shake_pos, roll_amplitude=shake_roll
    )
    drift = jnp.arange(n_frames, dtype=jnp.float32) * pan_per_frame * 0.01
    pos = shaken.position.at[:, 0].add(drift)
    return shaken._replace(position=pos)
