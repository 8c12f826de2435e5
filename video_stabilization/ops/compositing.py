"""Warp-mask and feathered trail compositing — the reference's dormant path.

The reference carries an unused "trail" rendering pipeline it kept for
"offline / GPU-accelerated" future use: a corner-polygon warp mask
(createWarpedMask, src/stabilizer.cpp:1011-1040; inline duplicate in
warpFrame :881-903), a Gaussian-feathered alpha compositor over a fading
background (copyFeathered, :1051-1155 — kernel 101 blur on the mask, x0.99
background fade), and the translation-shift helper t = s(I-R)c
(computeTranslationShift, :1042-1049).  Here these are cheap fused map
ops, so the trail renderer is actually usable in real time.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from video_stabilization.motion.similarity import transform_points
from video_stabilization.ops.pyramid import sep_filter5
from video_stabilization.ops.warp import warp_affine


def compute_translation_shift(scale: jax.Array, theta: jax.Array,
                              center: jax.Array) -> jax.Array:
    """t_shift = (I - s·R(θ)) · c (reference: computeTranslationShift,
    src/stabilizer.cpp:1042-1049)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    sr = scale * jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])
    eye = jnp.eye(2, dtype=sr.dtype)
    return jnp.matmul(eye - sr, center, precision=jax.lax.Precision.HIGHEST)


def warped_mask(h: jax.Array, height: int, width: int) -> jax.Array:
    """Binary mask of where the warped source lands in the destination.

    The reference rasterizes the perspective-transformed corner polygon with
    fillConvexPoly (src/stabilizer.cpp:1011-1040); for affine transforms the
    interior test is four half-plane inequalities — one fused elementwise
    program, no rasterizer.
    """
    corners = jnp.array(
        [[0.0, 0.0], [width - 1.0, 0.0], [width - 1.0, height - 1.0],
         [0.0, height - 1.0]], jnp.float32,
    )
    warped = transform_points(h.astype(jnp.float32), corners)    # (4, 2)

    ys = jnp.arange(height, dtype=jnp.float32)[:, None]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]

    inside = jnp.ones((height, width), bool)
    for i in range(4):
        a = warped[i]
        b = warped[(i + 1) % 4]
        # positive side of each (counter-clockwise in y-down coords) edge
        cross = (b[0] - a[0]) * (ys - a[1]) - (b[1] - a[1]) * (xs - a[0])
        inside = inside & (cross >= 0.0)
    return inside


def _big_blur(img: jax.Array, passes: int = 12) -> jax.Array:
    """Approximate the reference's kernel-101 Gaussian feather with repeated
    5-tap blurs (variance adds: 12 passes ~ sigma 5.5 x decimation-free)."""
    x = img
    for _ in range(passes):
        x = sep_filter5(x)
    return x


def copy_feathered(
    frame: jax.Array,
    background: jax.Array,
    h: jax.Array,
    fade: float = 0.99,
    feather_passes: int = 12,
) -> jax.Array:
    """Warp ``frame`` by ``h`` and alpha-blend it over a fading background.

    The reference's copyFeathered (src/stabilizer.cpp:1051-1155): the warp
    mask is blurred into a feathered alpha, the background decays by
    ``fade`` per frame, and the warped frame is composited on top.  Returns
    the new background/composite (the caller carries it between frames, like
    trail_background_).
    """
    frame = frame.astype(jnp.float32)
    background = background.astype(jnp.float32)
    hgt, wid = frame.shape[0], frame.shape[1]

    warped = warp_affine(frame, h, border_value=0.0)
    mask = warped_mask(h, hgt, wid).astype(jnp.float32)
    alpha = jnp.clip(_big_blur(mask, feather_passes), 0.0, 1.0)
    # feather only inside the warped region (reference multiplies the
    # blurred mask by the hard mask so edges fade inward)
    alpha = alpha * mask
    if frame.ndim == 3:
        alpha = alpha[..., None]

    faded = background * fade
    return alpha * warped + (1.0 - alpha) * faded
