"""Homography parameterization: decompose / compose / 2x2 QR.

Re-derivation of the reference's motion-model math core
(reference: src/stabilizer.cpp:1342-1566, docs/math-overview.md "Homography
Decomposition").  A 3x3 homography H (8 DoF after fixing h33=1) is uniquely
factored as

    H = [[ A            t+ ],        A  = s·R(θ)·K + t+·vᵀ
         [ vᵀ           1  ]]        K  = [[k1, δ], [0, k2]],  k1·k2 = 1

into {s: isotropic scale, θ: rotation, k1: anisotropy, δ: shear,
t ∈ R²: translation (re-centered about ``rot_center``), v ∈ R²: horizon shift}.

Differences from the reference, by design:

- **Pure functions, no exceptions.**  The reference returns ``false`` and
  prints to stderr on degeneracies (h33≈0, det≤0 — src/stabilizer.cpp:
  1447-1485).  Here every function returns a ``valid`` mask alongside the
  result and substitutes safe values, so the code jits and vmaps cleanly.
- **Batched by construction.**  All functions accept arbitrary leading batch
  dimensions; the engine calls them on (W, 3, 3) transform windows and the
  RANSAC module on (num_hypotheses, ...) stacks.
- **f32 on device** (the reference uses f64 CV_64F throughout).  The decomposition
  is closed-form with one sqrt and one atan2; f32 round-trip error is ~1e-6,
  verified by tests/test_homography.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-9


class HomographyParams(NamedTuple):
    """Pytree of decomposition parameters (reference: include/stabilizer.hpp:44-59).

    All leaves carry identical leading batch dimensions.
    """

    scale: jax.Array        # isotropic scale s, shape (...,)
    theta: jax.Array        # rotation angle θ (radians), shape (...,)
    k: jax.Array            # anisotropic ratio k1 (k2 = 1/k1), shape (...,)
    delta: jax.Array        # shear δ, shape (...,)
    t: jax.Array            # translation, shape (..., 2)
    v: jax.Array            # horizon/perspective shift, shape (..., 2)

    @staticmethod
    def identity(batch_shape: Tuple[int, ...] = (), dtype=jnp.float32) -> "HomographyParams":
        return HomographyParams(
            scale=jnp.ones(batch_shape, dtype),
            theta=jnp.zeros(batch_shape, dtype),
            k=jnp.ones(batch_shape, dtype),
            delta=jnp.zeros(batch_shape, dtype),
            t=jnp.zeros(batch_shape + (2,), dtype),
            v=jnp.zeros(batch_shape + (2,), dtype),
        )


def identity_homography(batch_shape: Tuple[int, ...] = (), dtype=jnp.float32) -> jax.Array:
    """Batched 3x3 identity matrices."""
    eye = jnp.eye(3, dtype=dtype)
    return jnp.broadcast_to(eye, batch_shape + (3, 3))


def qr_2x2(a: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Closed-form Gram-Schmidt QR of batched 2x2 matrices.

    Returns ``(q, r, valid)`` with ``a ≈ q @ r``, q orthogonal, r upper
    triangular with non-negative diagonal (for det(a) > 0, q is a proper
    rotation).  ``valid`` is False where ``a`` is numerically singular; there
    q = I, r = I are substituted.  (Reference: src/stabilizer.cpp:1342-1432 —
    but without the throw-on-failure self-check; validity is a returned mask.)
    """
    a = jnp.asarray(a)
    a11, a12 = a[..., 0, 0], a[..., 0, 1]
    a21, a22 = a[..., 1, 0], a[..., 1, 1]

    norm1 = jnp.sqrt(a11 * a11 + a21 * a21)
    det = a11 * a22 - a12 * a21
    valid = (norm1 > _EPS) & (jnp.abs(det) > _EPS)

    safe_norm1 = jnp.where(valid, norm1, 1.0)
    q11 = jnp.where(valid, a11 / safe_norm1, 1.0)
    q21 = jnp.where(valid, a21 / safe_norm1, 0.0)

    # r12 = q1 · a2 ; second column orthogonalized and normalized.
    r12 = q11 * a12 + q21 * a22
    u2x = a12 - r12 * q11
    u2y = a22 - r12 * q21
    norm2 = jnp.sqrt(u2x * u2x + u2y * u2y)
    valid = valid & (norm2 > _EPS)
    safe_norm2 = jnp.where(valid, norm2, 1.0)
    q12 = jnp.where(valid, u2x / safe_norm2, 0.0)
    q22 = jnp.where(valid, u2y / safe_norm2, 1.0)

    r11 = jnp.where(valid, norm1, 1.0)
    r22 = jnp.where(valid, norm2, 1.0)
    r12 = jnp.where(valid, r12, 0.0)

    q = jnp.stack(
        [jnp.stack([q11, q12], axis=-1), jnp.stack([q21, q22], axis=-1)], axis=-2
    )
    zeros = jnp.zeros_like(r11)
    r = jnp.stack(
        [jnp.stack([r11, r12], axis=-1), jnp.stack([zeros, r22], axis=-1)], axis=-2
    )
    return q, r, valid


def decompose_homography(
    h: jax.Array, rot_center: jax.Array
) -> Tuple[HomographyParams, jax.Array]:
    """Decompose batched 3x3 homographies about ``rot_center``.

    Args:
      h: (..., 3, 3) homographies.
      rot_center: (..., 2) or (2,) fixed point of the similarity part —
        normally the image center (docs/math-overview.md §7 "Translation
        Correction": t = t⁺ − (I − sR)c).

    Returns:
      (params, valid) — where ``valid`` is False the homography was degenerate
      (h33 ≈ 0 or det(sRK) ≤ 0; reference src/stabilizer.cpp:1447-1485) and
      identity parameters are substituted.
    """
    h = jnp.asarray(h)
    dtype = h.dtype
    rot_center = jnp.broadcast_to(jnp.asarray(rot_center, dtype), h.shape[:-2] + (2,))

    h33 = h[..., 2, 2]
    valid = jnp.abs(h33) > _EPS
    hn = h / jnp.where(valid, h33, 1.0)[..., None, None]

    t_plus = hn[..., 0:2, 2]                         # top-right 2x1
    v = hn[..., 2, 0:2]                              # bottom-left 1x2
    a = hn[..., 0:2, 0:2]                            # upper-left 2x2
    # Projective correction: sRK = A − t⁺ vᵀ.
    srk = a - t_plus[..., :, None] * v[..., None, :]

    det = srk[..., 0, 0] * srk[..., 1, 1] - srk[..., 0, 1] * srk[..., 1, 0]
    valid = valid & (det > _EPS)
    s = jnp.sqrt(jnp.where(valid, det, 1.0))

    rk = srk / s[..., None, None]
    q, r, qr_valid = qr_2x2(rk)
    valid = valid & qr_valid

    theta = jnp.arctan2(q[..., 1, 0], q[..., 0, 0])
    k1 = r[..., 0, 0]
    delta = r[..., 0, 1]

    # Re-center translation about c: t = t⁺ − (I − sR)c.
    sr = s[..., None, None] * q
    i_minus_sr = jnp.broadcast_to(jnp.eye(2, dtype=dtype), sr.shape) - sr
    shift = jnp.einsum("...ij,...j->...i", i_minus_sr, rot_center,
                       precision=jax.lax.Precision.HIGHEST)
    t = t_plus - shift

    ident = HomographyParams.identity(h.shape[:-2], dtype)
    vm = valid

    def pick(x, ident_x):
        extra = x.ndim - vm.ndim
        m = vm.reshape(vm.shape + (1,) * extra)
        return jnp.where(m, x, ident_x)

    params = HomographyParams(
        scale=pick(s, ident.scale),
        theta=pick(theta, ident.theta),
        k=pick(k1, ident.k),
        delta=pick(delta, ident.delta),
        t=pick(t, ident.t),
        v=pick(v, ident.v),
    )
    return params, valid


def compose_homography(params: HomographyParams, rot_center: jax.Array) -> jax.Array:
    """Exact inverse of :func:`decompose_homography`.

    Rebuilds H (with h33 = 1) from parameters about ``rot_center``
    (reference: src/stabilizer.cpp:1535-1566)::

        t_shifted = t + (I − sR)c
        A = sRK + t_shifted vᵀ
        H = [[A, t_shifted], [vᵀ, 1]]
    """
    s, theta, k1, delta, t, v = params
    dtype = s.dtype
    batch = s.shape
    rot_center = jnp.broadcast_to(jnp.asarray(rot_center, dtype), batch + (2,))

    c, sn = jnp.cos(theta), jnp.sin(theta)
    rot = jnp.stack(
        [jnp.stack([c, -sn], axis=-1), jnp.stack([sn, c], axis=-1)], axis=-2
    )
    k2 = 1.0 / k1
    zeros = jnp.zeros_like(k1)
    kmat = jnp.stack(
        [jnp.stack([k1, delta], axis=-1), jnp.stack([zeros, k2], axis=-1)], axis=-2
    )

    sr = s[..., None, None] * rot
    srk = jnp.einsum("...ij,...jk->...ik", sr, kmat,
                     precision=jax.lax.Precision.HIGHEST)

    i_minus_sr = jnp.broadcast_to(jnp.eye(2, dtype=dtype), sr.shape) - sr
    t_shifted = t + jnp.einsum("...ij,...j->...i", i_minus_sr, rot_center,
                               precision=jax.lax.Precision.HIGHEST)

    a = srk + t_shifted[..., :, None] * v[..., None, :]

    top = jnp.concatenate([a, t_shifted[..., :, None]], axis=-1)        # (...,2,3)
    ones = jnp.ones(batch + (1, 1), dtype)
    bottom = jnp.concatenate([v[..., None, :], ones], axis=-1)          # (...,1,3)
    return jnp.concatenate([top, bottom], axis=-2)


def remove_isotropic_scale(h: jax.Array, rot_center: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Force s = 1 in the decomposition about ``rot_center``, turning a
    similarity into a rigid transform (reference: src/stabilizer.cpp:261-267,
    752-758 — "kill isotropic scaling" after estimateAffinePartial2D).

    Returns ``(h_rigid, valid)``; where invalid, the input is replaced by
    identity (matching the reference's identity fallback at :268-272).
    """
    params, valid = decompose_homography(h, rot_center)
    params = params._replace(scale=jnp.ones_like(params.scale))
    h_rigid = compose_homography(params, rot_center)
    eye = identity_homography(h.shape[:-2], h.dtype)
    m = valid[..., None, None]
    return jnp.where(m, h_rigid, eye), valid
