"""The per-frame stabilization step — one jitted pure function.

Re-architecture of ``Stabilizer::stabilizeFrame`` (reference:
src/stabilizer.cpp:1158-1325) as

    stabilize_step : (carry, frame_u8) -> (carry', (output_u8, out_valid))

with all state explicit (engine/state.py).  Per-frame pipeline, mirroring
SURVEY.md §3.2 but restructured for XLA:

  1. full-res BGR -> working-res gray (+ pyramid, computed once, carried)
  2. LK-track previous corners into this frame      [hot]
  3. RANSAC similarity + isotropic-scale removal -> inter-frame T  [hot]
  4. ring-buffer updates (frames circular, transforms rolled)
  5. smoothing homography Q (always, like the reference)
  6. accumulated-lock homography (anchor/advance/invert)
  7. rotation split: H_translation_lock / H_rotation_lock via decomposition
  8. mode switch (lax.switch on the carried mode scalar)
  9. translation rescale to full resolution; warp presentation frame [hot]
 10. GFTT for the next frame                        [hot]

Differences from the reference, by design:
  - TRANSLATION_LOCK / ROTATION_LOCK are *implemented* (the reference leaves
    H_lock identity for them, making both no-ops — src/stabilizer.cpp:790 and
    README "[Not fully implemented yet]"): they anchor and advance the same
    accumulated transform as ACCUMULATED_FULL_LOCK and split it through the
    decomposition at step 7.
  - ORB/SIFT registration locks run the full detect/describe/match/fit
    pipeline (engine/lock.py) with a per-instance sticky fallback in the
    carry (the reference's process-global mutable static at
    src/stabilizer.cpp:446 is deliberately not replicated).
  - The first frame returns the input unchanged (quirk #1) and outputs are
    flagged invalid during warm-up so the app layer can reproduce the
    reference's "Buffering frames: k/n" behavior.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from video_stabilization.config import StabilizationMode, StabilizerConfig
from video_stabilization.engine.lock import orb_lock, sift_lock
from video_stabilization.engine.smoothing import smoothing_homography
from video_stabilization.engine.state import EngineCarry, RegistrationRef, init_carry
from video_stabilization.motion.homography import (
    HomographyParams,
    compose_homography,
    decompose_homography,
    remove_isotropic_scale,
)
from video_stabilization.motion.ransac import estimate_similarity_ransac
from video_stabilization.ops.gftt import good_features_to_track
from video_stabilization.ops.image import (
    bgr_to_gray, gray_u8_cv2exact, resize_bilinear,
)
from video_stabilization.ops.lk import lk_track
from video_stabilization.ops.pyramid import build_pyramid
from video_stabilization.ops.warp import _inv3x3, warp_affine, warp_perspective


def _rotation_about(theta: jax.Array, center: jax.Array) -> jax.Array:
    """cv::getRotationMatrix2D(center, theta_deg) equivalent: rotation by
    -theta (y-down convention) about center, as a 3x3 homography."""
    p = HomographyParams(
        scale=jnp.ones_like(theta),
        theta=-theta,
        k=jnp.ones_like(theta),
        delta=jnp.zeros_like(theta),
        t=jnp.zeros(theta.shape + (2,), theta.dtype),
        v=jnp.zeros(theta.shape + (2,), theta.dtype),
    )
    return compose_homography(p, center)


def _fit_inter_frame(src, dst, status, key, config: StabilizerConfig, center):
    """RANSAC motion fit of tracked correspondences + isotropic-scale removal
    (reference: estimateMotion, src/stabilizer.cpp:211-275).  Shared by the
    streaming step and the offline batched pipeline."""
    if config.ransac.motion_model == "rigid":
        # reference path: similarity fit, then kill isotropic scale about
        # the image center (src/stabilizer.cpp:224-267)
        ransac = estimate_similarity_ransac(src, dst, status, key, config.ransac)
        t_rigid, _ = remove_isotropic_scale(ransac.h, center)
    else:
        # richer motion family: similarity hypotheses select inliers, the
        # configured model refits on them (LO-RANSAC; models.motion_models)
        from video_stabilization.models.motion_models import (
            MotionModel, fit_motion,
        )

        model = MotionModel(config.ransac.motion_model)
        ransac = estimate_similarity_ransac(
            src, dst, status, key, config.ransac,
            refit_fn=lambda s, d, w: fit_motion(model, s, d, w, center),
        )
        t_rigid = ransac.h
    return ransac, t_rigid


def frame_keys(base_key: jax.Array, n: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-frame PRNG keys as a pure function of (base key, frame counter):
    (k_ransac, k_lock).  Index-derived (fold_in) rather than chained (split)
    so the offline batched pipeline draws the SAME randomness as the
    streaming step for the same absolute frame index."""
    k_ransac = jax.random.fold_in(base_key, n * 2)
    k_lock = jax.random.fold_in(base_key, n * 2 + 1)
    return k_ransac, k_lock


def stabilize_step(
    carry: EngineCarry,
    frame: jax.Array,
    config: StabilizerConfig,
    ext_motion=None,
) -> Tuple[EngineCarry, Tuple[jax.Array, jax.Array]]:
    """Process one (Hf, Wf, C) uint8 BGR frame; see module docstring.

    ``ext_motion``: optional ``(h (3,3) f32, valid bool, n_inliers i32)``
    inter-frame similarity computed by a HOST estimator stage (the cv2exact
    RANSAC replica, motion/cv2_ransac.py) — when given, the in-step LK/RANSAC
    stages are skipped and the de-scale (reference src/stabilizer.cpp:261-267)
    applies to the external estimate.  Used by the reference-compat fidelity
    path, which splits the step explicitly around the host stage.
    """
    w = config.total_window
    future = config.future_frames
    wh, ww = config.working_size
    center = jnp.array([ww / 2.0, wh / 2.0], jnp.float32)
    scale_factor = jnp.float32(config.scale_factor)

    key = carry.key
    k_ransac, k_lock = frame_keys(key, carry.n)

    # -- 1. working-res gray + pyramid ---------------------------------------
    # (named_scope annotations carry through to XLA op names, so profiler
    # traces attribute device time to the reference's printTimings categories —
    # utils/stage_profile.py aggregates them)
    with jax.named_scope("stage_gray_pyramid"):
        if config.reference_compat:
            # BIT-EXACT u8 gray (cv2's fixed-point resize + cvtColor,
            # ops/image.py gray_u8_cv2exact): a ±1 LSB gray difference
            # perturbs GFTT responses/LK enough to desynchronize the
            # cv2exact RANSAC hypothesis stream downstream
            gray = gray_u8_cv2exact(frame, wh, ww)
        else:
            # resize BEFORE gray (reference order, src/stabilizer.cpp:
            # 1170-1175): the strided-slice resize touches 1/9th of the
            # 1080p frame and no full-res float gray is ever materialized
            # (the two linear ops commute exactly for channel-independent
            # bilinear weights)
            small = resize_bilinear(frame.astype(jnp.float32), wh, ww)
            gray = bgr_to_gray(small)
        pyr = build_pyramid(gray, config.lk.pyramid_levels)

    # -- 2-3. track + estimate inter-frame motion ----------------------------
    if ext_motion is None:
        with jax.named_scope("stage_lk"):
            tracked = lk_track(carry.pyr_prev, pyr, carry.corners_prev,
                               carry.corners_mask, config.lk)
        with jax.named_scope("stage_fit"):
            ransac, t_rigid = _fit_inter_frame(
                carry.corners_prev, tracked.points, tracked.status, k_ransac,
                config, center,
            )
        fit_valid = ransac.valid
        n_inliers = ransac.num_inliers
    else:
        # already rigid: the host stage de-scaled in float64
        t_rigid, fit_valid, n_inliers = ext_motion
    is_first = carry.n == 0
    have_prev = carry.n >= 1
    t_new = jnp.where(have_prev & fit_valid, t_rigid, jnp.eye(3))

    # -- 4. ring updates ------------------------------------------------------
    n_after = carry.n + 1
    slot = jnp.mod(carry.n, w)
    frames = jax.lax.dynamic_update_slice(
        carry.frames, frame[None].astype(jnp.uint8), (slot, 0, 0, 0)
    )
    # transforms: roll left, write newest at the end (only once two frames
    # exist; the first frame contributes no transform)
    def push_transform(args):
        tr, tv = args
        tr = jnp.concatenate([tr[1:], t_new[None]], axis=0)
        tv = jnp.concatenate([tv[1:], jnp.ones((1,), bool)], axis=0)
        return tr, tv

    transforms, tvalid = jax.lax.cond(
        have_prev, push_transform, lambda a: a, (carry.transforms, carry.tvalid)
    )

    # -- window geometry -----------------------------------------------------
    length = jnp.minimum(n_after, w)                    # frames in window
    num_tr = length - 1                                 # valid transforms
    pres = jnp.where(length > future, length - future - 1, 0)

    # presentation frame (needed by both the registration locks and the warp)
    pres_abs = jnp.where(n_after > future, n_after - future - 1, 0)
    pres_slot = jnp.mod(pres_abs, w)
    pres_frame = jax.lax.dynamic_slice(
        frames, (pres_slot, 0, 0, 0), (1,) + frames.shape[1:]
    )[0].astype(jnp.float32)

    # -- 5. smoothing --------------------------------------------------------
    with jax.named_scope("stage_smoothing"):
        h_smooth = smoothing_homography(
            transforms, tvalid, pres, num_tr, config.reference_compat
        )

    # -- 6. lock transform (accumulated / ORB / SIFT) -------------------------
    # Absolute presentation index advances iff n_after - 1 - future >= 1.
    accum_modes = (
        StabilizationMode.ACCUMULATED_FULL_LOCK,
        StabilizationMode.TRANSLATION_LOCK,
        StabilizationMode.ROTATION_LOCK,
    )
    mode_val = (
        carry.mode if config.static_mode is None
        else jnp.asarray(config.static_mode, jnp.int32)
    )
    if config.reference_compat:
        # reference: TRANSLATION/ROTATION locks are no-ops (H_lock identity,
        # src/stabilizer.cpp:790); only ACCUMULATED accumulates.
        in_accum_mode = mode_val == int(StabilizationMode.ACCUMULATED_FULL_LOCK)
    else:
        in_accum_mode = jnp.isin(
            mode_val, jnp.array([int(m) for m in accum_modes])
        )

    advanced = (n_after - 1 - future) >= 1
    # transform into the current presentation frame = chronological index
    # pres-1 -> array slot (w-1 - num_tr + pres - 1)
    tr_slot = jnp.clip((transforms.shape[0] - num_tr) + pres - 1, 0, w - 2)
    t_pres = transforms[tr_slot]

    def lock_update(args):
        accum_h, active = args

        def anchor(_):
            return jnp.eye(3, dtype=jnp.float32), jnp.ones((), bool)

        def advance(args2):
            h, a = args2
            h2 = jnp.where(
                advanced,
                jnp.matmul(t_pres, h, precision=jax.lax.Precision.HIGHEST),
                h,
            )
            return h2, a

        return jax.lax.cond(active, advance, anchor, (accum_h, active))

    def lock_clear(args):
        return jnp.eye(3, dtype=jnp.float32), jnp.zeros((), bool)

    def accum_branch(_):
        accum_h, accum_active = jax.lax.cond(
            in_accum_mode, lock_update, lock_clear,
            (carry.accum_h, carry.accum_active),
        )
        return (
            _inv3x3(accum_h), accum_h, accum_active,
            carry.orb_ref, carry.sift_ref, carry.lock_prev_h,
            jnp.zeros((), jnp.int32),
        )

    def orb_branch(_):
        res = orb_lock(pres_frame, carry.orb_ref, carry.lock_prev_h, k_lock, config)
        return (
            res.h_lock, jnp.eye(3, dtype=jnp.float32), jnp.zeros((), bool),
            res.ref, carry.sift_ref, res.prev_h, res.n_matches,
        )

    def sift_branch(_):
        res = sift_lock(pres_frame, carry.sift_ref, carry.lock_prev_h, k_lock, config)
        return (
            res.h_lock, jnp.eye(3, dtype=jnp.float32), jnp.zeros((), bool),
            carry.orb_ref, res.ref, res.prev_h, res.n_matches,
        )

    if config.static_mode is None:
        # runtime mode switching (reference semantics): lax.switch runs the
        # selected branch only — correct and cheap single-stream
        branch_idx = jnp.where(
            carry.mode == int(StabilizationMode.ORB_FULL_LOCK), 1,
            jnp.where(carry.mode == int(StabilizationMode.SIFT_FULL_LOCK), 2, 0),
        )
        with jax.named_scope("stage_lock"):
            (h_lock, accum_h, accum_active, orb_ref, sift_ref, lock_prev_h,
             lock_matches) = (
                jax.lax.switch(
                    branch_idx, [accum_branch, orb_branch, sift_branch], None
                )
            )
    else:
        # mode pinned at trace time (stream-batched throughput path): only
        # the needed branch is traced, so vmap never pays for the others
        static_branch = {
            int(StabilizationMode.ORB_FULL_LOCK): orb_branch,
            int(StabilizationMode.SIFT_FULL_LOCK): sift_branch,
        }.get(int(config.static_mode), accum_branch)
        with jax.named_scope("stage_lock"):
            (h_lock, accum_h, accum_active, orb_ref, sift_ref, lock_prev_h,
             lock_matches) = (
                static_branch(None)
            )

    # -- 7. rotation split ----------------------------------------------------
    lock_params, lock_ok = decompose_homography(h_lock, center)
    h_lock = jnp.where(lock_ok, h_lock, jnp.eye(3))
    r_aug = _rotation_about(lock_params.theta, center)
    h_translation_lock = jnp.matmul(r_aug, h_lock, precision=jax.lax.Precision.HIGHEST)
    h_rotation_lock = _rotation_about(-lock_params.theta, center)

    # -- 8. mode switch -------------------------------------------------------
    branches = [
        lambda: h_smooth,            # GLOBAL_SMOOTHING = 0
        lambda: h_lock,              # ACCUMULATED_FULL_LOCK = 1
        lambda: h_lock,              # ORB_FULL_LOCK = 2 (registration vs ref)
        lambda: h_lock,              # SIFT_FULL_LOCK = 3 (registration vs ref)
        lambda: h_translation_lock,  # TRANSLATION_LOCK = 4
        lambda: h_rotation_lock,     # ROTATION_LOCK = 5
    ]
    if config.static_mode is None:
        h_stabilize = jax.lax.switch(carry.mode, branches)
    else:
        h_stabilize = branches[int(config.static_mode)]()

    # -- 9. rescale + warp ----------------------------------------------------
    # conjugate working-res H to full res: the affine block is scale-
    # invariant, translation divides by the factor (reference does exactly
    # this, valid for its rigid model, src/stabilizer.cpp:1291-1296); a
    # projective row would multiply by it (homography model only).
    with jax.named_scope("stage_warp"):
        h_scaled = h_stabilize.at[0:2, 2].set(h_stabilize[0:2, 2] / scale_factor)
        avg_color = 0.5 * jnp.mean(pres_frame, axis=(0, 1))
        if config.ransac.motion_model == "homography":
            h_scaled = h_scaled.at[2, 0:2].set(h_scaled[2, 0:2] * scale_factor)
            warped = warp_perspective(pres_frame, h_scaled, None, avg_color)
        else:
            # affine by construction (rigid/similarity/affine estimates, rigid
            # accumulations, averages of those)
            warped = warp_affine(pres_frame, h_scaled, border_value=avg_color)
        warped_u8 = jnp.clip(jnp.round(warped), 0, 255).astype(jnp.uint8)

    # quirk #1: the first frame is returned unstabilized
    output = jnp.where(is_first, frame.astype(jnp.uint8), warped_u8)
    out_valid = jnp.ones((), bool)  # a frame is always emitted (app may buffer)

    # -- 10. features for the next frame --------------------------------------
    if config.gftt.selection == "host":
        # the host injects ops/gftt_host.py's element-exact corner list into
        # the carry after this step (Stabilizer.stabilize_frame, cv2exact
        # split) — emit empty lanes instead of tracing the jitted detector
        from video_stabilization.ops.gftt import Corners

        nf = config.gftt.max_features
        corners = Corners(points=jnp.zeros((nf, 2), jnp.float32),
                          response=jnp.zeros((nf,), jnp.float32),
                          mask=jnp.zeros((nf,), bool))
    else:
        if config.reference_compat and config.gftt.selection != "cv2exact":
            # drift-vs-reference parity needs cv2's exact greedy corner list
            # (corner-set selection was the dominant drift term, VERDICT r2)
            import dataclasses

            gftt_cfg = dataclasses.replace(config.gftt, selection="cv2exact")
        else:
            gftt_cfg = config.gftt
        with jax.named_scope("stage_gftt"):
            corners = good_features_to_track(gray, gftt_cfg)

    new_carry = EngineCarry(
        frames=frames,
        transforms=transforms,
        tvalid=tvalid,
        pyr_prev=pyr,
        corners_prev=corners.points,
        corners_mask=corners.mask,
        n=n_after,
        mode=carry.mode,
        accum_h=accum_h,
        accum_active=accum_active,
        orb_ref=orb_ref,
        sift_ref=sift_ref,
        lock_prev_h=lock_prev_h,
        last_h=h_stabilize,
        last_inliers=n_inliers,
        last_lock_matches=lock_matches,
        key=key,
    )
    return new_carry, (output, out_valid)


@functools.lru_cache(maxsize=32)
def make_scan_fn(config: StabilizerConfig) -> Callable:
    """Jitted (carry, frames (T, Hf, Wf, C)) -> (carry, (outputs, valid)) —
    a ``lax.scan`` of the per-frame step over a clip.

    One dispatch processes the whole clip: this is the offline/throughput
    path (the reference is strictly frame-at-a-time; per-frame host dispatch
    would add its own cost to every step).  The carry is donated;
    the frame stack is not, so a caller may re-feed the same clip.
    """
    step = functools.partial(stabilize_step, config=config)

    def scan_fn(carry, frames):
        return jax.lax.scan(step, carry, frames)

    return jax.jit(scan_fn, donate_argnums=0)


@functools.lru_cache(maxsize=32)
def make_track_fn(config: StabilizerConfig) -> Callable:
    """Jitted (carry, frame) -> (tracked_points, status): the gray/pyramid/LK
    prefix of the step, for the host-estimator (cv2exact RANSAC) split.  The
    main step re-derives gray/pyramid itself — the duplicate is confined to
    the fidelity path where exactness, not speed, is the point."""
    wh, ww = config.working_size

    def track(carry: EngineCarry, frame: jax.Array):
        if config.reference_compat:
            gray = gray_u8_cv2exact(frame, wh, ww)
        else:
            small = resize_bilinear(frame.astype(jnp.float32), wh, ww)
            gray = bgr_to_gray(small)
        pyr = build_pyramid(gray, config.lk.pyramid_levels)
        tracked = lk_track(carry.pyr_prev, pyr, carry.corners_prev,
                           carry.corners_mask, config.lk)
        return tracked.points, tracked.status

    return jax.jit(track)


@functools.lru_cache(maxsize=32)
def make_step_ext_fn(config: StabilizerConfig) -> Callable:
    """Jitted (carry, frame, ext_motion) -> (carry, (output, valid)) — the
    step with the inter-frame similarity supplied by a host estimator stage
    (see ``stabilize_step``'s ``ext_motion``)."""

    def step_ext(carry, frame, ext_motion):
        return stabilize_step(carry, frame, config, ext_motion)

    return jax.jit(step_ext, donate_argnums=0)


@functools.lru_cache(maxsize=32)
def make_step_fn(config: StabilizerConfig) -> Callable:
    """Jitted (carry, frame) -> (carry, (output, valid)) specialized to config.

    - The carry is donated: its dominant buffer is the full-resolution frame
      ring (hundreds of MB at 1080p), which is updated in place instead of
      reallocated per step — without donation a deeply pipelined stream of
      steps holds one ring per in-flight step and exhausts device memory.
    - Cached per config (StabilizerConfig is frozen/hashable): every
      Stabilizer instance with the same config shares one compiled
      executable instead of re-jitting (a fresh ``partial`` would otherwise
      defeat jax's jit cache).
    """
    return jax.jit(
        functools.partial(stabilize_step, config=config), donate_argnums=0
    )


class Stabilizer:
    """Host-side convenience wrapper mirroring the reference's public API
    (include/stabilizer.hpp:137-198): construct with window sizes, feed frames
    one at a time, switch modes at runtime.

    For production multi-stream throughput use the functional API directly
    (``make_step_fn`` + vmap/shard_map, see ``parallel``); this class wraps a
    single stream.
    """

    def __init__(self, config: StabilizerConfig, mode: StabilizationMode = StabilizationMode.GLOBAL_SMOOTHING, seed: int = 0):
        self.config = config
        if config.ransac.method == "cv2exact":
            if config.ransac.motion_model != "rigid":
                raise ValueError("cv2exact RANSAC supports the rigid model only")
            self._step = make_step_ext_fn(config)
            self._track = make_track_fn(config)
        else:
            self._step = make_step_fn(config)
            self._track = None
        self.carry = init_carry(config, int(mode), jax.random.key(seed))

    def set_stabilization_mode(self, mode: StabilizationMode) -> None:
        """Switch modes; clears lock state, preserves the frame/transform
        window (reference: src/stabilizer.cpp:55-96)."""
        import jax.numpy as _jnp

        def _cleared(ref):
            return RegistrationRef(
                points=_jnp.zeros_like(ref.points),
                desc=_jnp.zeros_like(ref.desc),
                mask=_jnp.zeros_like(ref.mask),
                gray=_jnp.zeros_like(ref.gray),
                is_set=_jnp.zeros((), bool),
            )

        self.carry = self.carry._replace(
            mode=_jnp.asarray(int(mode), _jnp.int32),
            accum_h=_jnp.eye(3, dtype=_jnp.float32),
            accum_active=_jnp.zeros((), bool),
            orb_ref=_cleared(self.carry.orb_ref),
            sift_ref=_cleared(self.carry.sift_ref),
            lock_prev_h=_jnp.eye(3, dtype=_jnp.float32),
            last_lock_matches=_jnp.zeros((), _jnp.int32),
        )

    def stabilize_frame(self, frame) -> "jax.Array":
        """Feed one (Hf, Wf, C) uint8 BGR frame; returns the stabilized
        (delayed) output frame."""
        f = jnp.asarray(frame)
        if self._track is not None:
            # host estimator stage: jitted track prefix -> bit-exact
            # cv2.estimateAffinePartial2D replica on host -> jitted step
            import numpy as np

            from video_stabilization.motion.cv2_ransac import (
                estimate_rigid_cv2_host,
            )

            pts, status = self._track(self.carry, f)
            src = np.asarray(self.carry.corners_prev, np.float32)
            wh, ww = self.config.working_size
            h, valid, n_inl = estimate_rigid_cv2_host(
                src, np.asarray(pts, np.float32), np.asarray(status, bool),
                center=(ww / 2.0, wh / 2.0),
                min_points=self.config.ransac.min_points,
                ransac_reproj_threshold=self.config.ransac.inlier_threshold,
            )
            ext = (jnp.asarray(h, jnp.float32), jnp.asarray(valid),
                   jnp.asarray(n_inl, jnp.int32))
            self.carry, (output, _) = self._step(self.carry, f, ext)
            if self.config.gftt.selection == "host":
                # element-exact corner stage (ops/gftt_host.py): inject cv2's
                # exact list so the next frame's hypothesis stream stays
                # synchronized with the reference pipeline
                from video_stabilization.ops.gftt_host import (
                    detect_corners_host,
                )

                min_dist = (self.config.gftt.min_distance_at_720
                            * (wh / 720.0))
                pts_np, mask_np = detect_corners_host(
                    np.asarray(frame, np.uint8), (wh, ww),
                    self.config.gftt.max_features,
                    self.config.gftt.quality_level, min_dist)
                self.carry = self.carry._replace(
                    corners_prev=jnp.asarray(pts_np),
                    corners_mask=jnp.asarray(mask_np))
            return output
        self.carry, (output, _) = self._step(self.carry, f)
        return output

    def stabilize_clip(self, frames) -> "jax.Array":
        """Feed a whole (T, Hf, Wf, C) uint8 clip in one device dispatch
        (lax.scan over the per-frame step); returns the (T, Hf, Wf, C)
        stabilized outputs.  Offline/throughput path — streaming callers use
        :meth:`stabilize_frame`."""
        scan = make_scan_fn(self.config)
        self.carry, (outputs, _) = scan(self.carry, jnp.asarray(frames))
        return outputs

    @property
    def total_frame_window_size(self) -> int:
        return self.config.total_window
