"""Motion-model family: rigid / similarity / affine / homography fits.

The reference fixes its motion model to a de-scaled similarity
(estimateAffinePartial2D + scale removal, src/stabilizer.cpp:224-267) and
carries a disabled full-homography path ("#if 0", :227-229; the math doc
explains when to prefer it, docs/math-overview.md "Image registration").
Here every family is a first-class, jit-compatible fit over masked
correspondences, selectable per engine config:

- RIGID:      similarity fit + isotropic-scale removal (reference default)
- SIMILARITY: closed-form Umeyama LS (4 DoF)
- AFFINE:     6-DoF weighted normal equations
- HOMOGRAPHY: 8-DoF normalized DLT (the reference's disabled path, enabled)

All fits are weighted/masked and vmappable, so each can serve as the RANSAC
refit kernel.
"""

from __future__ import annotations

import enum
from typing import Tuple

import jax
import jax.numpy as jnp

from video_stabilization.motion.homography import remove_isotropic_scale
from video_stabilization.motion.similarity import fit_similarity_masked

_EPS = 1e-8
# the normal equations solve geometry: keep full f32 (no TF32) products
_HIGH = jax.lax.Precision.HIGHEST


class MotionModel(enum.Enum):
    RIGID = "rigid"
    SIMILARITY = "similarity"
    AFFINE = "affine"
    HOMOGRAPHY = "homography"


def fit_affine_masked(src, dst, weights) -> Tuple[jax.Array, jax.Array]:
    """Weighted LS affine fit (6 DoF) via 3x3 normal equations per output
    coordinate."""
    w = weights.astype(jnp.float32)
    ones = jnp.ones_like(src[..., :1])
    a = jnp.concatenate([src, ones], axis=-1)            # (N, 3)
    aw = a * w[..., None]
    ata = jnp.matmul(a.T, aw, precision=_HIGH)            # (3, 3)
    det_ok = jnp.abs(jnp.linalg.det(ata)) > _EPS
    ata_safe = jnp.where(det_ok, ata, jnp.eye(3))
    atb = jnp.matmul(aw.T, dst, precision=_HIGH)          # (3, 2)
    sol = jnp.linalg.solve(ata_safe, atb)                 # (3, 2)
    h = jnp.concatenate(
        [sol.T, jnp.array([[0.0, 0.0, 1.0]])], axis=0
    )
    valid = det_ok & jnp.all(jnp.isfinite(h)) & (jnp.sum(w > 0) >= 3)
    return jnp.where(valid, h, jnp.eye(3)), valid


def fit_homography_dlt(src, dst, weights) -> Tuple[jax.Array, jax.Array]:
    """Weighted normalized DLT homography fit (8 DoF).

    Hartley-normalized coordinates, 2N x 9 design matrix, smallest singular
    vector via one eigendecomposition of the 9x9 normal matrix — closed-form
    enough to jit and vmap (no iterative solver).
    """
    w = weights.astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), _EPS)

    def normalize(pts):
        mu = jnp.sum(w[:, None] * pts, axis=0) / wsum
        d = jnp.sqrt(jnp.sum((pts - mu) ** 2, axis=-1))
        mean_d = jnp.maximum(jnp.sum(w * d) / wsum, _EPS)
        s = jnp.sqrt(2.0) / mean_d
        t = jnp.array([
            [s, 0.0, -s * mu[0]],
            [0.0, s, -s * mu[1]],
            [0.0, 0.0, 1.0],
        ])
        return (pts - mu) * s, t

    sn, t_src = normalize(src)
    dn, t_dst = normalize(dst)

    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = jnp.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    a = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)  # (2N, 9)

    ata = jnp.matmul(a.T, a, precision=_HIGH)
    evals, evecs = jnp.linalg.eigh(ata)
    hvec = evecs[:, 0]                                    # smallest eigenvalue
    hn = hvec.reshape(3, 3)

    # denormalize: H = T_dst^-1 Hn T_src
    h = jnp.linalg.solve(t_dst, jnp.matmul(hn, t_src, precision=_HIGH))
    h33 = h[2, 2]
    valid = (jnp.abs(h33) > _EPS) & (jnp.sum(w > 0) >= 4)
    h = h / jnp.where(valid, h33, 1.0)
    valid = valid & jnp.all(jnp.isfinite(h))
    return jnp.where(valid, h, jnp.eye(3)), valid


def fit_motion(
    model: MotionModel,
    src: jax.Array,
    dst: jax.Array,
    weights: jax.Array,
    rot_center: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Fit the chosen motion family to masked correspondences."""
    if model is MotionModel.SIMILARITY:
        return fit_similarity_masked(src, dst, weights)
    if model is MotionModel.RIGID:
        h, ok = fit_similarity_masked(src, dst, weights)
        h2, ok2 = remove_isotropic_scale(h, rot_center)
        return h2, ok & ok2
    if model is MotionModel.AFFINE:
        return fit_affine_masked(src, dst, weights)
    if model is MotionModel.HOMOGRAPHY:
        return fit_homography_dlt(src, dst, weights)
    raise ValueError(model)
