"""RANSAC similarity estimation — vmapped hypotheses, fixed shapes.

Replacement for OpenCV's ``estimateAffinePartial2D(..., RANSAC)``
(reference: src/stabilizer.cpp:224-225 for the LK path, :734-736 for the
ORB/SIFT lock path).  OpenCV's RANSAC loop is sequential with data-dependent
early exit; here all ``num_hypotheses`` minimal samples are drawn up front,
all similarity hypotheses are solved in one batched closed-form LS
(``similarity_from_2pt``), all point residuals are evaluated as one
(hypotheses × points) broadcast, and the best hypothesis is an
``argmax`` — fully static shapes, one kernel launch, no host sync.

After model selection, the inlier set is refined with a couple of reweighted
least-squares passes (OpenCV refines with Levenberg-Marquardt; for a
similarity the LS refit is closed-form and exact per iteration).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from video_stabilization.config import RansacConfig
from video_stabilization.motion.homography import identity_homography
from video_stabilization.motion.similarity import (
    fit_similarity_masked,
    similarity_from_2pt,
    transform_points,
)


class RansacResult(NamedTuple):
    h: jax.Array            # (3, 3) similarity as homography (last row 0,0,1)
    valid: jax.Array        # () bool — False => h is identity (fallback)
    inliers: jax.Array      # (N,) bool inlier mask
    num_inliers: jax.Array  # () int32


def estimate_similarity_ransac(
    src: jax.Array,
    dst: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    config: RansacConfig = RansacConfig(),
    inlier_threshold: float | None = None,
    refit_fn=None,
) -> RansacResult:
    """Robust similarity fit of masked correspondences ``src -> dst``.

    Args:
      src, dst: (N, 2) point arrays (fixed capacity N).
      mask: (N,) bool validity of each correspondence.
      key: PRNG key for hypothesis sampling.
      config: RANSAC parameters.
      inlier_threshold: override of ``config.inlier_threshold`` (the reference
        uses 3.0 px default for the LK path but 5.0 for the lock path).

    Returns identity + valid=False when fewer than ``config.min_points`` valid
    correspondences exist (reference: src/stabilizer.cpp:215-216) or when no
    hypothesis reaches ``min_points`` inliers (identity fallback, :241-242).

    ``refit_fn(src, dst, weights) -> (h, valid)`` overrides the inlier-set
    refinement model (LO-RANSAC style: similarity hypotheses select inliers,
    the chosen motion family — e.g. affine or DLT homography from
    ``models.motion_models`` — refines on them).  Default: similarity LS.
    """
    if refit_fn is None:
        refit_fn = fit_similarity_masked
    dtype = jnp.asarray(src).dtype
    n = src.shape[0]
    thresh = inlier_threshold if inlier_threshold is not None else config.inlier_threshold
    maskf = mask.astype(dtype)
    num_valid = jnp.sum(mask.astype(jnp.int32))
    enough = num_valid >= config.min_points

    # --- Hypothesis sampling -------------------------------------------------
    # Draw 2 distinct indices per hypothesis, restricted to valid lanes: one
    # argsort packs the valid lane indices to the front, then each hypothesis
    # samples two distinct slots modulo num_valid.  (A Gumbel-top-k draw per
    # hypothesis costs H sorts over N lanes; this is one sort + a tiny
    # gather.)
    order = jnp.argsort(jnp.where(mask, 0, 1), stable=True)     # valid first
    bits = jax.random.bits(key, (config.num_hypotheses,), jnp.uint32)
    nv = jnp.maximum(num_valid, 2).astype(jnp.uint32)
    j1 = (bits & 0xFFFF) % nv
    j2 = (j1 + 1 + (bits >> 16) % (nv - 1)) % nv                # distinct from j1
    idx = order[jnp.stack([j1, j2], axis=1).astype(jnp.int32)]  # (H, 2)

    samp_src = src[idx]                                  # (H, 2, 2)
    samp_dst = dst[idx]
    h_hyp, hyp_valid = similarity_from_2pt(samp_src, samp_dst)   # (H,3,3), (H,)

    # --- Scoring -------------------------------------------------------------
    proj = transform_points(h_hyp, src[None, :, :])      # (H, N, 2)
    resid2 = jnp.sum((proj - dst[None, :, :]) ** 2, axis=-1)
    inlier = (resid2 < thresh * thresh) & mask[None, :]  # (H, N)
    counts = jnp.sum(inlier, axis=-1)
    counts = jnp.where(hyp_valid, counts, -1)
    best = jnp.argmax(counts)
    best_count = counts[best]

    # --- Refinement ----------------------------------------------------------
    # Re-fit LS on the inlier set, re-threshold, repeat (static iterations).
    def refine(carry, _):
        h_cur, inl = carry
        h_new, fit_valid = refit_fn(src, dst, inl.astype(dtype) * maskf)
        h_new = jnp.where(fit_valid, h_new, h_cur)
        proj = transform_points(h_new, src)
        r2 = jnp.sum((proj - dst) ** 2, axis=-1)
        inl_new = (r2 < thresh * thresh) & mask
        return (h_new, inl_new), None

    init_inl = inlier[best]
    (h_ref, inl_ref), _ = jax.lax.scan(
        refine, (h_hyp[best], init_inl), None, length=config.refine_iters
    )

    final_count = jnp.sum(inl_ref.astype(jnp.int32))
    ok = enough & (best_count >= config.min_points) & (final_count >= 3)
    # Guard non-finite results (reference NaN check, src/stabilizer.cpp:241-242).
    ok = ok & jnp.all(jnp.isfinite(h_ref))

    eye = identity_homography((), dtype)
    h_out = jnp.where(ok, h_ref, eye)
    return RansacResult(
        h=h_out,
        valid=ok,
        inliers=inl_ref & ok,
        num_inliers=jnp.where(ok, final_count, 0),
    )
