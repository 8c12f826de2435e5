"""JAX ray-cast floor-texture camera simulator.

Re-design of the reference's ``CameraEngine``
(reference: src/camera_engine.cpp:73-172, include/camera_engine.hpp:31-33):
a pinhole camera flying over an infinitely tiled textured floor plane (z=0),
with a light-blue sky above the horizon.  The reference renders with a
per-pixel C++ loop under ``cv::parallel_for_``; here the whole frame is one
broadcasted jnp expression — XLA fuses ray generation, rotation, plane
intersection, tiling, and the texel gather into a single fused kernel, and
``vmap`` batches over streams.

Beyond the reference, this module also provides the **analytic inter-frame
homography** induced by the floor plane between two camera poses
(:func:`inter_frame_homography`).  That is the ground truth the reference
never had: scripted camera trajectories + analytic homographies let every
pipeline stage be tested end-to-end against exact expected motion
(SURVEY.md §4 "Implication for the new framework").

Conventions (identical to the reference):
  - pixel ray (camera frame): d = (x - cx, y - cy, f); no normalization is
    needed because the plane-intersection parameter t = -Cz/dz rescales it
    away (the reference normalizes, reaching the same intersection point).
  - R = Rz(roll) · Rx(tilt) · Ry(pan), camera->world (src/camera_engine.cpp:36-61).
  - sky where the ray is parallel to the floor or points away from it:
    |dz| < eps or dz·Cz >= 0 (src/camera_engine.cpp:119).
  - floor tile: 1.0 world units wide, 1/aspect high; nearest-texel fetch
    (src/camera_engine.cpp:83-89, 144-152).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Host constant (see ops/pyramid.py note on device-array globals).
SKY_COLOR_BGR = np.array([230, 216, 173], np.uint8)  # light blue, BGR
_EPS = 1e-9


class CameraParams(NamedTuple):
    """Camera pose + intrinsics pytree (reference: include/camera_engine.hpp:44-74).

    Angles are degrees, matching the reference's keyboard-driven control.
    """

    position: jax.Array       # (3,) world position (x, y, z); floor is z=0
    pan: jax.Array            # () yaw about Y, degrees
    tilt: jax.Array           # () pitch about X, degrees
    roll: jax.Array           # () roll about Z, degrees
    focal_length: jax.Array   # () pixels

    @staticmethod
    def create(position=(0.0, 0.0, 1.0), pan=0.0, tilt=105.0, roll=180.0,
               focal_length=1000.0) -> "CameraParams":
        return CameraParams(
            position=jnp.asarray(position, jnp.float32),
            pan=jnp.asarray(pan, jnp.float32),
            tilt=jnp.asarray(tilt, jnp.float32),
            roll=jnp.asarray(roll, jnp.float32),
            focal_length=jnp.asarray(focal_length, jnp.float32),
        )


# Class defaults (include/camera_engine.hpp:44-74) and the demo app's start
# pose (src/main.cpp:29-36).
DEFAULT_PARAMS = CameraParams.create()
DEFAULT_APP_PARAMS = CameraParams.create(
    position=(0.5, -0.3, 0.7), pan=0.0, tilt=180.0, roll=180.0
)


def rotation_matrix(pan_deg: jax.Array, tilt_deg: jax.Array, roll_deg: jax.Array) -> jax.Array:
    """Camera->world rotation R = Rz(roll) · Rx(tilt) · Ry(pan)."""
    p = jnp.deg2rad(pan_deg)
    t = jnp.deg2rad(tilt_deg)
    r = jnp.deg2rad(roll_deg)
    cp, sp = jnp.cos(p), jnp.sin(p)
    ct, st = jnp.cos(t), jnp.sin(t)
    cr, sr = jnp.cos(r), jnp.sin(r)
    ry = jnp.stack([
        jnp.stack([cp, jnp.zeros_like(cp), sp]),
        jnp.stack([jnp.zeros_like(cp), jnp.ones_like(cp), jnp.zeros_like(cp)]),
        jnp.stack([-sp, jnp.zeros_like(cp), cp]),
    ])
    rx = jnp.stack([
        jnp.stack([jnp.ones_like(ct), jnp.zeros_like(ct), jnp.zeros_like(ct)]),
        jnp.stack([jnp.zeros_like(ct), ct, -st]),
        jnp.stack([jnp.zeros_like(ct), st, ct]),
    ])
    rz = jnp.stack([
        jnp.stack([cr, -sr, jnp.zeros_like(cr)]),
        jnp.stack([sr, cr, jnp.zeros_like(cr)]),
        jnp.stack([jnp.zeros_like(cr), jnp.zeros_like(cr), jnp.ones_like(cr)]),
    ])
    hp = jax.lax.Precision.HIGHEST
    return jnp.matmul(rz, jnp.matmul(rx, ry, precision=hp), precision=hp)


def render_frame(
    texture: jax.Array,
    params: CameraParams,
    height: int,
    width: int,
) -> jax.Array:
    """Render one (height, width, 3) uint8 BGR frame.

    ``texture`` is (th, tw, 3) uint8 BGR; principal point is the image center
    (reference: src/camera_engine.cpp:160-162).
    """
    th, tw = texture.shape[0], texture.shape[1]
    cx = width / 2.0
    cy = height / 2.0

    r = rotation_matrix(params.pan, params.tilt, params.roll)
    cam = params.position

    ys = jnp.arange(height, dtype=jnp.float32)[:, None]   # (H,1)
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]    # (1,W)
    u = xs - cx                                           # (1,W) -> bcast (H,W)
    v = ys - cy

    # World ray direction (unnormalized; t rescales it away).
    f = params.focal_length
    dx = r[0, 0] * u + r[0, 1] * v + r[0, 2] * f
    dy = r[1, 0] * u + r[1, 1] * v + r[1, 2] * f
    dz = r[2, 0] * u + r[2, 1] * v + r[2, 2] * f

    sky = (jnp.abs(dz) < _EPS) | (dz * cam[2] >= 0)
    dz_safe = jnp.where(sky, 1.0, dz)
    t = -cam[2] / dz_safe
    wx = cam[0] + t * dx
    wy = cam[1] + t * dy

    # Infinite tiling: tile is 1.0 world units wide, 1/aspect high; the
    # fractional part x - floor(x) equals the reference's double-fmod into
    # [0, 1) for all finite inputs.
    aspect = tw / th
    tile_x = wx  # / tile_width (1.0)
    tile_y = wy * aspect  # / tile_height (1/aspect)
    tex_u = tile_x - jnp.floor(tile_x)
    tex_v = tile_y - jnp.floor(tile_y)

    ix = jnp.clip((tex_u * tw).astype(jnp.int32), 0, tw - 1)
    iy = jnp.clip((tex_v * th).astype(jnp.int32), 0, th - 1)

    floor_rgb = texture[iy, ix]                           # (H, W, 3) gather
    sky_rgb = jnp.broadcast_to(SKY_COLOR_BGR, floor_rgb.shape)
    return jnp.where(sky[..., None], sky_rgb, floor_rgb)


# --- Movement (pure functions: params -> params) ----------------------------
# Reference: src/camera_engine.cpp:175-219. Column 2 of R is the camera
# forward axis, column 0 the right axis, column 1 points down (so "up" is its
# negation).

def _axis(params: CameraParams, col: int) -> jax.Array:
    r = rotation_matrix(params.pan, params.tilt, params.roll)
    return r[:, col]


def move_forward(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return params._replace(position=params.position + _axis(params, 2) * (amount * move_speed))


def move_backward(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return params._replace(position=params.position - _axis(params, 2) * (amount * move_speed))


def move_right(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return params._replace(position=params.position + _axis(params, 0) * (amount * move_speed))


def move_left(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return params._replace(position=params.position - _axis(params, 0) * (amount * move_speed))


def move_up(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return params._replace(position=params.position - _axis(params, 1) * (amount * move_speed))


def move_down(params: CameraParams, amount, move_speed=0.1) -> CameraParams:
    return params._replace(position=params.position + _axis(params, 1) * (amount * move_speed))


def roll_clockwise(params: CameraParams, amount, roll_speed=2.0) -> CameraParams:
    return params._replace(roll=params.roll - amount * roll_speed)


def roll_counterclockwise(params: CameraParams, amount, roll_speed=2.0) -> CameraParams:
    return params._replace(roll=params.roll + amount * roll_speed)


# --- Analytic ground truth ---------------------------------------------------

def plane_to_pixel_homography(
    params: CameraParams, height: int, width: int
) -> jax.Array:
    """Homography G mapping floor-plane world coords (X, Y, 1) to pixels.

    Derivation: a world point on z=0 is P = (X, Y, 0); the camera projects
    p ~ K · Rᵀ · (P − C) with K = [[f,0,cx],[0,f,cy],[0,0,1]] and R the
    camera->world rotation used by the renderer.  Writing P − C =
    M·(X, Y, 1)ᵀ with M = [[1,0,−Cx],[0,1,−Cy],[0,0,−Cz]] gives G = K·Rᵀ·M.
    """
    cx = width / 2.0
    cy = height / 2.0
    f = params.focal_length
    zero = jnp.zeros_like(f)
    one = jnp.ones_like(f)
    k = jnp.stack([
        jnp.stack([f, zero, cx * one]),
        jnp.stack([zero, f, cy * one]),
        jnp.stack([zero, zero, one]),
    ])
    r = rotation_matrix(params.pan, params.tilt, params.roll)
    c = params.position
    m = jnp.stack([
        jnp.stack([one, zero, -c[0]]),
        jnp.stack([zero, one, -c[1]]),
        jnp.stack([zero, zero, -c[2]]),
    ])
    hp = jax.lax.Precision.HIGHEST
    return jnp.matmul(k, jnp.matmul(r.T, m, precision=hp), precision=hp)


def inter_frame_homography(
    params_a: CameraParams, params_b: CameraParams, height: int, width: int
) -> jax.Array:
    """Exact homography H with p_b ~ H · p_a for floor pixels, i.e. the
    ground-truth inter-frame camera motion the stabilizer must estimate."""
    ga = plane_to_pixel_homography(params_a, height, width)
    gb = plane_to_pixel_homography(params_b, height, width)
    h = jnp.matmul(gb, jnp.linalg.inv(ga), precision=jax.lax.Precision.HIGHEST)
    return h / h[2, 2]
