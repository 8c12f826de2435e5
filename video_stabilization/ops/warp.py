"""Warping — the output-rendering op.

Equivalent of ``cv::warpPerspective(src, H, size, INTER_LINEAR,
BORDER_CONSTANT, border_value)`` (reference: src/stabilizer.cpp:1309-1314;
the reference fills the border with 0.5x the mean frame color).

Both entry points are one per-pixel inverse map plus a 4-tap bilinear
gather with a constant border:

- :func:`warp_perspective` — any homography (projective divide).
- :func:`warp_affine` — the engine's transforms, which are affine by
  construction (estimateMotion kills scale, reference
  src/stabilizer.cpp:261-267; lock and smoothing compose rigid motions);
  the projective row of ``h`` is ignored, so no divide is taken.

Like OpenCV, ``h`` maps SOURCE coords to DESTINATION coords in both.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-12


def _inv3x3(m: jax.Array) -> jax.Array:
    """Closed-form 3x3 inverse (adjugate / det) — avoids linalg solve inside
    the per-frame step."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    det = jnp.where(jnp.abs(det) > _EPS, det, 1.0)
    adj = jnp.array(
        [
            [ca, -(b * i - c * h), b * f - c * e],
            [cb, a * i - c * g, -(a * f - c * d)],
            [cc, -(a * h - b * g), a * e - b * d],
        ]
    )
    return adj / det


def _bilinear_sample(
    src: jax.Array, sx: jax.Array, sy: jax.Array, border_value
) -> jax.Array:
    """Sample ``src`` (H, W) or (H, W, C) at the (out_h, out_w) source
    coordinates ``sx``/``sy``, bilinear with a constant border: each of the
    4 taps outside the source reads ``border_value`` (scalar or (C,)), as
    OpenCV's BORDER_CONSTANT does, so the output is continuous in the
    transform; a pixel whose 4 taps are all outside is exactly the
    border."""
    has_c = src.ndim == 3
    sh, sw = src.shape[0], src.shape[1]

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = x0i + 1
    y1i = y0i + 1

    border = jnp.asarray(border_value, jnp.float32)
    if has_c:
        border = jnp.broadcast_to(border, (src.shape[2],))
        fx = fx[..., None]
        fy = fy[..., None]

    def tap(yi, xi):
        ok = (xi >= 0) & (xi <= sw - 1) & (yi >= 0) & (yi <= sh - 1)
        v = src[jnp.clip(yi, 0, sh - 1), jnp.clip(xi, 0, sw - 1)]
        return jnp.where(ok[..., None] if has_c else ok, v, border), ok

    v00, ok00 = tap(y0i, x0i)
    v01, ok01 = tap(y0i, x1i)
    v10, ok10 = tap(y1i, x0i)
    v11, ok11 = tap(y1i, x1i)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    out = top * (1.0 - fy) + bot * fy
    any_in = ok00 | ok01 | ok10 | ok11
    return jnp.where(any_in[..., None] if has_c else any_in, out, border)


def warp_perspective(
    src: jax.Array,
    h: jax.Array,
    out_shape: Tuple[int, int] | None = None,
    border_value: jax.Array | float = 0.0,
) -> jax.Array:
    """Warp ``src`` by homography ``h`` (src->dst), bilinear + constant border.

    Args:
      src: (H, W) or (H, W, C) image, any real dtype (computed in float32).
      h: (3, 3) homography mapping source pixel coords to destination coords.
      out_shape: (out_h, out_w); defaults to the source shape.
      border_value: scalar or (C,) fill for out-of-bounds samples.

    Returns the warped float32 image with the same rank as ``src``.
    """
    src = src.astype(jnp.float32)
    out_h, out_w = out_shape if out_shape is not None else src.shape[:2]

    hinv = _inv3x3(h.astype(jnp.float32))

    ys = jnp.arange(out_h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(out_w, dtype=jnp.float32)[None, :]
    # projective map of destination pixel -> source coords
    denom = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
    denom = jnp.where(jnp.abs(denom) > _EPS, denom, _EPS)
    sx = (hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / denom
    sy = (hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / denom
    return _bilinear_sample(src, sx, sy, border_value)


def warp_affine(
    src: jax.Array,
    h: jax.Array,
    border_value: jax.Array | float = 0.0,
) -> jax.Array:
    """Warp ``src`` by the affine transform ``h`` (src->dst pixel coords),
    bilinear, constant border, output the size of ``src``.

    Any rotation, scale or shear is exact; there is no envelope.  The
    projective row of ``h`` is ignored.

    Args:
      src: (H, W) or (H, W, C) image, any real dtype (computed in float32).
      h: (3, 3) affine transform.
      border_value: scalar or (C,) fill for out-of-source pixels.
    """
    src = src.astype(jnp.float32)
    hh, ww = src.shape[:2]
    a = h.astype(jnp.float32)
    hinv = _inv3x3(a.at[2].set(jnp.array([0.0, 0.0, 1.0], jnp.float32)))

    ys = jnp.arange(hh, dtype=jnp.float32)[:, None]
    xs = jnp.arange(ww, dtype=jnp.float32)[None, :]
    sx = hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]
    sy = hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]
    return _bilinear_sample(src, sx, sy, border_value)
