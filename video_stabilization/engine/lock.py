"""Lock-mode transforms: accumulated flow and ORB/SIFT registration.

Re-design of ``calculateFullLockStabilization`` (reference:
src/stabilizer.cpp:311-791).  Three families:

- **Accumulated flow** (ACCUMULATED_FULL_LOCK; also the basis the corrected
  TRANSLATION/ROTATION locks build on): chain inter-frame transforms from an
  anchor presentation frame, return the inverse (:317-439).
- **ORB registration** (ORB_FULL_LOCK): register the presentation frame
  directly against a stored reference frame via FAST+BRIEF descriptors,
  Hamming kNN + Lowe ratio, RANSAC similarity, scale removal, inverse
  (:440-788).
- **SIFT registration** (SIFT_FULL_LOCK): same flow with DoG/SIFT features
  and L2 matching with the mean-distance filter (:675-707).

Failure behavior matches the reference's *sticky fallback* — the last
successfully computed lock transform is returned whenever detection/matching
/fitting fails (:642, :672, :706, :730, :749) — but stored per engine
instance in the carry, not in a process-wide function-local static (the
reference's shared-mutable-state hazard at :446 is deliberately fixed).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from video_stabilization.config import StabilizerConfig
from video_stabilization.engine.state import RegistrationRef
from video_stabilization.motion.homography import remove_isotropic_scale
from video_stabilization.motion.ransac import estimate_similarity_ransac
from video_stabilization.ops.filters import preprocess_for_registration
from video_stabilization.ops.image import bgr_to_gray, resize_nearest
from video_stabilization.ops.match import match_hamming_knn, match_l2
from video_stabilization.ops.orb import orb_detect_and_compute
from video_stabilization.ops.warp import _inv3x3


class LockResult(NamedTuple):
    h_lock: jax.Array       # (3, 3)
    ref: RegistrationRef    # possibly newly captured reference
    prev_h: jax.Array       # updated sticky fallback
    n_matches: jax.Array    # () int32 good matches (post ratio/dist filter)


def _registration_lock(
    feats_points: jax.Array,
    feats_desc: jax.Array,
    feats_mask: jax.Array,
    proc_gray: jax.Array,
    ref: RegistrationRef,
    prev_h: jax.Array,
    key: jax.Array,
    config: StabilizerConfig,
    center: jax.Array,
    use_hamming: bool,
) -> LockResult:
    """Shared register-against-reference logic for ORB and SIFT features."""

    def capture(_):
        # first call in this mode: current frame becomes the reference and
        # the sticky fallback resets to identity (reference :520-589, :528)
        new_ref = RegistrationRef(
            points=feats_points, desc=feats_desc, mask=feats_mask,
            gray=proc_gray, is_set=jnp.ones((), bool),
        )
        eye = jnp.eye(3, dtype=jnp.float32)
        return LockResult(h_lock=eye, ref=new_ref, prev_h=eye,
                          n_matches=jnp.zeros((), jnp.int32))

    def register(_):
        with jax.named_scope("stage_lock_match"):
            if use_hamming:
                m = match_hamming_knn(
                    ref.desc, ref.mask, feats_desc, feats_mask,
                    config.orb.lowe_ratio,
                )
            else:
                m = match_l2(
                    ref.desc, ref.mask, feats_desc, feats_mask,
                    config.sift.match_avg_ratio,
                    config.sift.match_min_distance,
                )
        src = ref.points
        dst = feats_points[m.idx]
        with jax.named_scope("stage_lock_ransac"):
            res = estimate_similarity_ransac(
                src, dst, m.valid, key, config.ransac,
                inlier_threshold=config.ransac.lock_inlier_threshold,
            )
        h_rigid, rigid_ok = remove_isotropic_scale(res.h, center)
        if config.ecc.enabled:
            # ECC refinement of the ref->curr transform against the stored
            # reference gray (the reference ships this disabled,
            # src/stabilizer.cpp:34; we can afford it)
            from video_stabilization.ops.ecc import ecc_refine_euclidean

            with jax.named_scope("stage_lock_ecc"):
                ecc = ecc_refine_euclidean(
                    ref.gray, proc_gray, h_rigid,
                    max_iters=config.ecc.max_iters, eps=config.ecc.epsilon,
                )
            h_rigid = jnp.where(ecc.valid, ecc.h, h_rigid)
        n_good = jnp.sum(m.valid.astype(jnp.int32))
        enough = (
            (jnp.sum(feats_mask) >= config.ransac.min_points)
            & (n_good >= config.ransac.min_points)
        )
        ok = res.valid & rigid_ok & enough
        h = jnp.where(ok, _inv3x3(h_rigid), prev_h)   # curr->ref, sticky
        return LockResult(h_lock=h, ref=ref, prev_h=h, n_matches=n_good)

    return jax.lax.cond(ref.is_set, register, capture, None)


def orb_lock(
    pres_frame: jax.Array,
    ref: RegistrationRef,
    prev_h: jax.Array,
    key: jax.Array,
    config: StabilizerConfig,
) -> LockResult:
    """ORB registration lock on the full-res presentation frame.

    Preprocessing mirrors the reference: independent INTER_NEAREST downscale
    to working size (:449-451), grayscale, then the median/sharpen/CLAHE
    chain (:464-477), then detect+describe with the relative-size filter.
    """
    wh, ww = config.working_size
    center = jnp.array([ww / 2.0, wh / 2.0], jnp.float32)
    with jax.named_scope("stage_lock_pre"):
        small = resize_nearest(pres_frame.astype(jnp.float32), wh, ww)
        gray = bgr_to_gray(small)
        proc = preprocess_for_registration(
            gray, config.preprocess.clahe_clip_limit,
            config.preprocess.clahe_tiles, config.preprocess.median_ksize,
        )
    with jax.named_scope("stage_lock_orb"):
        feats = orb_detect_and_compute(proc, config.orb)
    return _registration_lock(
        feats.points, feats.desc, feats.mask, proc, ref, prev_h, key, config,
        center, use_hamming=True,
    )


def sift_lock(
    pres_frame: jax.Array,
    ref: RegistrationRef,
    prev_h: jax.Array,
    key: jax.Array,
    config: StabilizerConfig,
) -> LockResult:
    """SIFT registration lock (same pipeline, SIFT features + L2 matching)."""
    from video_stabilization.ops.sift import sift_detect_and_compute

    wh, ww = config.working_size
    center = jnp.array([ww / 2.0, wh / 2.0], jnp.float32)
    with jax.named_scope("stage_lock_pre"):
        small = resize_nearest(pres_frame.astype(jnp.float32), wh, ww)
        gray = bgr_to_gray(small)
        proc = preprocess_for_registration(
            gray, config.preprocess.clahe_clip_limit,
            config.preprocess.clahe_tiles, config.preprocess.median_ksize,
        )
    with jax.named_scope("stage_lock_sift"):
        feats = sift_detect_and_compute(proc, config.sift)
    return _registration_lock(
        feats.points, feats.desc, feats.mask, proc, ref, prev_h, key, config,
        center, use_hamming=False,
    )
