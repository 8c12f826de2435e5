"""Masked least-squares similarity fitting.

Replacement for the inner solver of OpenCV's
``estimateAffinePartial2D`` (reference: src/stabilizer.cpp:224-225, 734-736).
A 2D similarity  p' = s·R(θ)·p + t  is linear in the parameterization
(a, b, tx, ty) with A = [[a, -b], [b, a]]; the weighted least-squares solution
is closed-form (Umeyama-style, via weighted centroids), so it vectorizes with
no iterative solve — and vmaps over RANSAC hypotheses.

All point sets are fixed-capacity arrays with validity masks (OpenCV's
variable-length vectors become masked lanes; SURVEY.md §7 "Hard parts").
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-8


def fit_similarity_masked(
    src: jax.Array, dst: jax.Array, weights: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Weighted LS similarity fit mapping ``src`` -> ``dst``.

    Args:
      src: (..., N, 2) source points.
      dst: (..., N, 2) destination points.
      weights: (..., N) non-negative weights (0 = masked out).

    Returns:
      (h, valid): h is (..., 3, 3) with last row [0,0,1]; valid is (...,) —
      False where fewer than 2 effective points or degenerate geometry, in
      which case h is identity.
    """
    src = jnp.asarray(src)
    dst = jnp.asarray(dst)
    w = jnp.asarray(weights, src.dtype)

    wsum = jnp.sum(w, axis=-1)
    valid = wsum > _EPS
    wsafe = jnp.where(valid, wsum, 1.0)

    mu_src = jnp.sum(w[..., None] * src, axis=-2) / wsafe[..., None]
    mu_dst = jnp.sum(w[..., None] * dst, axis=-2) / wsafe[..., None]

    ps = src - mu_src[..., None, :]
    pd = dst - mu_dst[..., None, :]

    # a = Σw (x·x' + y·y') / Σw (x²+y²);  b = Σw (x·y' − y·x') / Σw (x²+y²)
    denom = jnp.sum(w * jnp.sum(ps * ps, axis=-1), axis=-1)
    num_a = jnp.sum(w * jnp.sum(ps * pd, axis=-1), axis=-1)
    num_b = jnp.sum(
        w * (ps[..., 0] * pd[..., 1] - ps[..., 1] * pd[..., 0]), axis=-1
    )
    valid = valid & (denom > _EPS)
    dsafe = jnp.where(valid, denom, 1.0)
    a = jnp.where(valid, num_a / dsafe, 1.0)
    b = jnp.where(valid, num_b / dsafe, 0.0)

    # t = μ_dst − A μ_src
    tx = mu_dst[..., 0] - (a * mu_src[..., 0] - b * mu_src[..., 1])
    ty = mu_dst[..., 1] - (b * mu_src[..., 0] + a * mu_src[..., 1])
    tx = jnp.where(valid, tx, 0.0)
    ty = jnp.where(valid, ty, 0.0)

    zeros = jnp.zeros_like(a)
    ones = jnp.ones_like(a)
    h = jnp.stack(
        [
            jnp.stack([a, -b, tx], axis=-1),
            jnp.stack([b, a, ty], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return h, valid


def similarity_from_2pt(
    src: jax.Array, dst: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Exact similarity from two point correspondences.

    Args:
      src, dst: (..., 2, 2) point pairs.

    Returns:
      (h, valid) — identity and invalid where the two source points coincide.

    The 2-point LS solution is exact for a similarity, so this simply reuses
    :func:`fit_similarity_masked` with unit weights; kept as a named entry
    point because it is the RANSAC minimal solver.
    """
    w = jnp.ones(src.shape[:-1], src.dtype)
    return fit_similarity_masked(src, dst, w)


def transform_points(h: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply batched 3x3 homographies to (..., N, 2) points (projective)."""
    x, y = pts[..., 0], pts[..., 1]
    hx = h[..., 0, 0, None] * x + h[..., 0, 1, None] * y + h[..., 0, 2, None]
    hy = h[..., 1, 0, None] * x + h[..., 1, 1, None] * y + h[..., 1, 2, None]
    hw = h[..., 2, 0, None] * x + h[..., 2, 1, None] * y + h[..., 2, 2, None]
    hw = jnp.where(jnp.abs(hw) > _EPS, hw, 1.0)
    return jnp.stack([hx / hw, hy / hw], axis=-1)
