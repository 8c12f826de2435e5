"""ECC image alignment (Evangelidis-Psarakis), Euclidean motion model.

Equivalent of ``cv::findTransformECC(ref, cur, warp, MOTION_EUCLIDEAN)``.
The reference implements this refinement for the ORB/SIFT lock but ships it
disabled "for performance reasons" (src/stabilizer.cpp:34, :760-782,
README.md:241); each iteration is one bilinear warp plus fused
elementwise reductions, so it is enabled for the SIFT+ECC benchmark
config (BASELINE config 4).

Forward-additive ECC over p = (theta, tx, ty):

    W(x; p) = R(theta) x + t
    rho(p)  = <zm_t, zm_iw> / (||zm_t|| ||zm_iw||)

with the standard ECC update (lambda-scaled residual projected through the
Jacobian-weighted gradient Gram matrix).  Iterations run under a fixed
bound with a convergence freeze, like the rest of the framework.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from video_stabilization.ops.warp import _inv3x3, warp_affine

_HIGH = jax.lax.Precision.HIGHEST


class ECCResult(NamedTuple):
    h: jax.Array      # (3, 3) refined transform (maps ref coords -> cur coords)
    rho: jax.Array    # () final correlation coefficient
    valid: jax.Array  # () bool — improved & finite


def _euclidean_h(theta: jax.Array, tx: jax.Array, ty: jax.Array) -> jax.Array:
    c, s = jnp.cos(theta), jnp.sin(theta)
    zero = jnp.zeros_like(theta)
    one = jnp.ones_like(theta)
    return jnp.stack([
        jnp.stack([c, -s, tx]),
        jnp.stack([s, c, ty]),
        jnp.stack([zero, zero, one]),
    ])


def _params_from_h(h: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    theta = jnp.arctan2(h[1, 0], h[0, 0])
    return theta, h[0, 2], h[1, 2]


def ecc_refine_euclidean(
    ref: jax.Array,
    cur: jax.Array,
    h_init: jax.Array,
    max_iters: int = 50,
    eps: float = 1e-3,
) -> ECCResult:
    """Refine ``h_init`` so that cur(W(x)) aligns with ref(x).

    Args:
      ref, cur: (H, W) float32 grayscale images (working resolution).
      h_init: (3, 3) initial transform mapping ref pixel coords into cur
        (i.e. the warp that samples cur to produce a ref-aligned image —
        same convention as the inverse of the lock transform).
    """
    hgt, wid = ref.shape
    # all statistics over an interior crop: warp border fill would otherwise
    # poison the correlation (zeros vs content dominate the variance)
    m = max(8, min(hgt, wid) // 12)

    def interior(img):
        return img[m:hgt - m, m:wid - m]

    ys = jnp.arange(m, hgt - m, dtype=jnp.float32)[:, None]
    xs = jnp.arange(m, wid - m, dtype=jnp.float32)[None, :]

    t = interior(ref.astype(jnp.float32))
    zm_t = t - jnp.mean(t)
    t_norm2 = jnp.sum(zm_t * zm_t)

    theta0, tx0, ty0 = _params_from_h(h_init.astype(jnp.float32))

    def rho_of(iw_full):
        iw = interior(iw_full)
        zm_i = iw - jnp.mean(iw)
        denom = jnp.sqrt(t_norm2 * jnp.sum(zm_i * zm_i)) + 1e-12
        return jnp.sum(zm_t * zm_i) / denom

    def body(carry, _):
        theta, tx, ty, done = carry
        w = _euclidean_h(theta, tx, ty)
        # warp_affine samples src at hinv.dst; we need iw(x)=cur(W x)
        iw_full = warp_affine(cur, _inv3x3(w), border_value=0.0)

        gx_full = 0.5 * (jnp.roll(iw_full, -1, 1) - jnp.roll(iw_full, 1, 1))
        gy_full = 0.5 * (jnp.roll(iw_full, -1, 0) - jnp.roll(iw_full, 1, 0))
        iw = interior(iw_full)
        gx = interior(gx_full)
        gy = interior(gy_full)
        zm_i = iw - jnp.mean(iw)

        # chain rule: grad(iw) = grad(cur)(W x) . R, so grad(cur) = grad(iw) . Rᵀ
        # and d iw/dθ = grad(iw) . J x with J the rotation generator.
        c, s = jnp.cos(theta), jnp.sin(theta)
        g0 = -ys * gx + xs * gy            # d/dtheta
        g1 = c * gx + s * gy               # d/dtx
        g2 = -s * gx + c * gy              # d/dty

        def dot(a, b):
            return jnp.sum(a * b)

        gg = jnp.array([
            [dot(g0, g0), dot(g0, g1), dot(g0, g2)],
            [dot(g1, g0), dot(g1, g1), dot(g1, g2)],
            [dot(g2, g0), dot(g2, g1), dot(g2, g2)],
        ])
        gg_inv = jnp.linalg.inv(gg + 1e-6 * jnp.eye(3))

        gt = jnp.array([dot(g0, zm_t), dot(g1, zm_t), dot(g2, zm_t)])
        gi = jnp.array([dot(g0, zm_i), dot(g1, zm_i), dot(g2, zm_i)])

        # Gauss-Newton step in full f32 (TF32 would perturb the 3x3 solve)
        def mv(m, v):
            return jnp.matmul(m, v, precision=_HIGH)

        num = jnp.sum(zm_i * zm_i) - gi @ mv(gg_inv, gi)
        den = jnp.sum(zm_t * zm_i) - gt @ mv(gg_inv, gi)
        lam = jnp.where(jnp.abs(den) > 1e-8, num / den, 1.0)

        err0 = dot(lam * zm_t - zm_i, g0)
        err1 = dot(lam * zm_t - zm_i, g1)
        err2 = dot(lam * zm_t - zm_i, g2)
        dp = mv(gg_inv, jnp.array([err0, err1, err2]))
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0)

        small = jnp.sqrt(jnp.sum(dp * dp)) < eps
        upd = jnp.where(done, 0.0, 1.0)
        return (theta + upd * dp[0], tx + upd * dp[1], ty + upd * dp[2],
                done | small), None

    (theta, tx, ty, _), _ = jax.lax.scan(
        body, (theta0, tx0, ty0, jnp.zeros((), bool)), None, length=max_iters
    )

    h_ref = _euclidean_h(theta, tx, ty)
    iw_final = warp_affine(cur, _inv3x3(h_ref), border_value=0.0)
    rho_final = rho_of(iw_final)
    iw_init = warp_affine(cur, _inv3x3(h_init.astype(jnp.float32)), 0.0)
    rho_init = rho_of(iw_init)

    improved = (rho_final >= rho_init) & jnp.all(jnp.isfinite(h_ref))
    h_out = jnp.where(improved, h_ref, h_init)
    return ECCResult(h=h_out, rho=jnp.maximum(rho_final, rho_init), valid=improved)
