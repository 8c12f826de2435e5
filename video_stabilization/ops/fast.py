"""FAST-9/16 corner detection — fully vectorized.

The segment test: a pixel p is a corner if 9 or more *contiguous* pixels on
the 16-pixel Bresenham circle of radius 3 are all brighter than p+t or all
darker than p-t.  Instead of OpenCV's per-pixel early-exit byte machinery,
the 16 circle offsets become 16 shifted views of the image; contiguity is a
logical AND over 9 consecutive entries of the (wrapped) ring, evaluated for
all 16 arc starts at once — one fused elementwise program over (16+, H, W).

Score (the reference configures cv::ORB with FAST_SCORE,
src/stabilizer.cpp:483-493): for each arc, the weakest margin in the arc;
the score is the strongest such arc margin — the maximal threshold at which
the pixel remains a corner.

On the GPU, XLA materialises the (16, H, W) ring stack (15.7 MB of
scratch at 360x640); at the ORB pyramid's shapes the whole detector is a
small share of the ORB lock step (see PERF.md, Kernel B).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx)
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9


def fast_score(img: jax.Array, threshold: float) -> Tuple[jax.Array, jax.Array]:
    """Returns (score, is_corner) maps, zero within 3 px of the border."""
    img = img.astype(jnp.float32)
    h, w = img.shape
    pad = 3
    x = jnp.pad(img, pad, mode="edge")

    ring = jnp.stack(
        [x[pad + dy : pad + dy + h, pad + dx : pad + dx + w] for dy, dx in CIRCLE_OFFSETS],
        axis=0,
    )  # (16, H, W)

    bright_margin = ring - img[None]          # p_i - p

    def _roll(a, k):
        return jnp.concatenate([a[k:], a[:k]], axis=0)

    def arc9(margin, op):
        # windowed op over all 16 contiguous 9-arcs by doubling: 4 passes
        # over the (16, H, W) stack instead of 9 (HBM-bound stencil)
        m2 = op(margin, _roll(margin, 1))
        m4 = op(m2, _roll(m2, 2))
        m8 = op(m4, _roll(m4, 4))
        return op(m8, _roll(margin, 8))

    # dark arcs are the negated bright arcs: arc_min(-m) = -arc_max(m), so
    # one stack serves both polarities
    score_bright = jnp.max(arc9(bright_margin, jnp.minimum), axis=0)
    score_dark = jnp.max(-arc9(bright_margin, jnp.maximum), axis=0)
    score = jnp.maximum(score_bright, score_dark)

    is_corner = score > threshold
    border = jnp.zeros((h, w), bool).at[pad:-pad, pad:-pad].set(True)
    is_corner = is_corner & border
    score = jnp.where(is_corner, score, 0.0)
    return score, is_corner
