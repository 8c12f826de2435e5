"""Offline/throughput pipeline: batch the per-pair estimation over frames.

The streaming step (engine/stabilizer.py) mirrors the reference's strictly
sequential per-frame loop (src/stabilizer.cpp:1158-1325).  But the expensive
stages have NO sequential dependency across frames:

- gray/resize/pyramid of frame i depends only on frame i;
- GFTT corners of frame i depend only on frame i;
- LK tracking + RANSAC of the pair (i-1, i) depend only on those two frames
  (corners come from GFTT on frame i-1, not from any estimate);
- ORB/SIFT registration of presentation frame p depends only on frame p and
  the (fixed-once-captured) reference frame.

Only the cheap parts are sequential: the temporal transform window (3x3
matrices), the accumulated-lock prefix product, and the sticky registration
fallback — all O(T) tiny matrix chains.

So the throughput formulation processes a chunk of K consecutive
frames per dispatch:

  1. batch (vmap) gray+pyramid+GFTT over the K frames;
  2. batch LK + RANSAC over the K frame pairs (the previous chunk's last
     pyramid/corners seed pair 0);
  3. run the tiny sequential chains as ``associative_scan``s (accumulated
     lock = masked prefix matmul; smoothing windows = vmapped masked scans);
  4. batch the output warps over the K presentation frames.

Batching multiplies every kernel's parallel work by K, amortizing the
per-op fixed costs that dominate a single 360p frame (a 45x80 pyramid level
cannot fill the device; K levels stacked can).

Semantics: identical to feeding the K frames through ``stabilize_step`` one
at a time — including warm-up behavior, the first-frame quirk, lock
anchoring and sticky fallbacks, and (by deriving per-frame PRNG keys with
``fold_in`` on the absolute frame counter — engine/stabilizer.frame_keys)
the exact same RANSAC randomness.  Verified by tests/test_offline.py
against the streaming scan path.

Constraints: ``config.static_mode`` must be set (one compiled pipeline per
mode — the throughput path pins the mode like the stream-batched path), and
the chunk size must not exceed the temporal window W (the frame ring is
written once per chunk).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from video_stabilization.config import StabilizationMode, StabilizerConfig
from video_stabilization.engine.smoothing import smoothing_homography
from video_stabilization.engine.state import EngineCarry, RegistrationRef
from video_stabilization.engine.stabilizer import (
    _fit_inter_frame,
    _rotation_about,
    frame_keys,
)
from video_stabilization.motion.homography import (
    decompose_homography,
    remove_isotropic_scale,
)
from video_stabilization.motion.ransac import estimate_similarity_ransac
from video_stabilization.ops.gftt import good_features_to_track
from video_stabilization.ops.image import bgr_to_gray, resize_bilinear, resize_nearest
from video_stabilization.ops.lk import lk_track
from video_stabilization.ops.pyramid import build_pyramid
from video_stabilization.ops.warp import _inv3x3, warp_affine, warp_perspective

_ACCUM_MODES = (
    int(StabilizationMode.ACCUMULATED_FULL_LOCK),
    int(StabilizationMode.TRANSLATION_LOCK),
    int(StabilizationMode.ROTATION_LOCK),
)

_HIGH = jax.lax.Precision.HIGHEST


def _mul_newest_left(x: jax.Array, y: jax.Array) -> jax.Array:
    """associative_scan combiner for prefix products with the newest factor
    on the left: out_j = M_j · … · M_0 (the accumulated-lock chain order,
    reference src/stabilizer.cpp:330-336)."""
    return jnp.matmul(y, x, precision=_HIGH)


def _offline_registration(
    pres_frames: jax.Array,       # (K, Hf, Wf, C) uint8 presentation frames
    ref: RegistrationRef,
    prev_h0: jax.Array,
    keys: jax.Array,              # (K,) lock keys
    config: StabilizerConfig,
    use_orb: bool,
) -> Tuple[jax.Array, RegistrationRef, jax.Array, jax.Array]:
    """Batched ORB/SIFT registration of K presentation frames against the
    carried reference (capturing it from frame 0 if unset), + the sticky-
    fallback chain.  Mirrors engine/lock._registration_lock per lane."""
    from video_stabilization.ops.filters import preprocess_for_registration

    wh, ww = config.working_size
    center = jnp.array([ww / 2.0, wh / 2.0], jnp.float32)

    def detect(frame_u8):
        small = resize_nearest(frame_u8.astype(jnp.float32), wh, ww)
        gray = bgr_to_gray(small)
        proc = preprocess_for_registration(
            gray, config.preprocess.clahe_clip_limit,
            config.preprocess.clahe_tiles, config.preprocess.median_ksize,
        )
        if use_orb:
            from video_stabilization.ops.orb import orb_detect_and_compute

            feats = orb_detect_and_compute(proc, config.orb)
        else:
            from video_stabilization.ops.sift import sift_detect_and_compute

            feats = sift_detect_and_compute(proc, config.sift)
        return (feats.points, feats.desc, feats.mask), proc

    with jax.named_scope("stage_lock_detect"):
        (pts, desc, msk), procs = jax.vmap(detect)(pres_frames)

    # reference capture on the chunk's first step if unset (engine/lock.py
    # capture branch; reference src/stabilizer.cpp:520-589)
    captured_now = ~ref.is_set

    def pick(new0, old):
        return jnp.where(captured_now, new0, old)

    ref2 = RegistrationRef(
        points=pick(pts[0], ref.points),
        desc=pick(desc[0], ref.desc),
        mask=pick(msk[0], ref.mask),
        gray=pick(procs[0], ref.gray),
        is_set=jnp.ones((), bool),
    )

    def register(pts_j, desc_j, msk_j, proc_j, key_j):
        from video_stabilization.ops.match import match_hamming_knn, match_l2

        if use_orb:
            m = match_hamming_knn(ref2.desc, ref2.mask, desc_j, msk_j,
                                  config.orb.lowe_ratio)
        else:
            m = match_l2(ref2.desc, ref2.mask, desc_j, msk_j,
                         config.sift.match_avg_ratio,
                         config.sift.match_min_distance)
        src = ref2.points
        dst = pts_j[m.idx]
        res = estimate_similarity_ransac(
            src, dst, m.valid, key_j, config.ransac,
            inlier_threshold=config.ransac.lock_inlier_threshold,
        )
        h_rigid, rigid_ok = remove_isotropic_scale(res.h, center)
        if config.ecc.enabled:
            from video_stabilization.ops.ecc import ecc_refine_euclidean

            ecc = ecc_refine_euclidean(
                ref2.gray, proc_j, h_rigid,
                max_iters=config.ecc.max_iters, eps=config.ecc.epsilon,
            )
            h_rigid = jnp.where(ecc.valid, ecc.h, h_rigid)
        n_good = jnp.sum(m.valid.astype(jnp.int32))
        enough = (
            (jnp.sum(msk_j) >= config.ransac.min_points)
            & (n_good >= config.ransac.min_points)
        )
        ok = res.valid & rigid_ok & enough
        return _inv3x3(h_rigid), ok, n_good

    with jax.named_scope("stage_lock_register"):
        h_inv, ok, n_good = jax.vmap(register)(pts, desc, msk, procs, keys)

    eye = jnp.eye(3, dtype=jnp.float32)
    # capture step returns identity and resets the sticky fallback
    ok = ok.at[0].set(jnp.where(captured_now, True, ok[0]))
    h_inv = h_inv.at[0].set(jnp.where(captured_now, eye, h_inv[0]))
    n_good = n_good.at[0].set(jnp.where(captured_now, 0, n_good[0]))
    prev0 = jnp.where(captured_now, eye, prev_h0)

    def stick(prev, xy):
        h_j, ok_j = xy
        out = jnp.where(ok_j, h_j, prev)
        return out, out

    prev_last, h_seq = jax.lax.scan(stick, prev0, (h_inv, ok))
    return h_seq, ref2, prev_last, n_good


def offline_chunk_step(
    carry: EngineCarry,
    frames: jax.Array,
    config: StabilizerConfig,
) -> Tuple[EngineCarry, Tuple[jax.Array, jax.Array]]:
    """Process K consecutive frames (K static, <= total window) with batched
    heavy stages; semantically identical to K ``stabilize_step`` calls."""
    if config.static_mode is None:
        raise ValueError(
            "offline pipeline requires config.static_mode (one compiled "
            "pipeline per mode); use dataclasses.replace(config, "
            "static_mode=int(mode))"
        )
    mode = int(config.static_mode)
    k = frames.shape[0]
    w = config.total_window
    if k > w:
        raise ValueError(f"chunk size {k} exceeds temporal window {w}")
    future = config.future_frames
    wh, ww = config.working_size
    center = jnp.array([ww / 2.0, wh / 2.0], jnp.float32)
    scale_factor = jnp.float32(config.scale_factor)
    eye = jnp.eye(3, dtype=jnp.float32)

    n0 = carry.n
    idxs = jnp.arange(k, dtype=jnp.int32)
    ns = n0 + idxs
    k_ransac, k_lock = jax.vmap(lambda n: frame_keys(carry.key, n))(ns)

    # -- 1. batched gray + pyramid + GFTT -------------------------------------
    with jax.named_scope("stage_gray_pyramid"):
        # resize-then-gray: see engine/stabilizer.py (reference op order)
        grays = jax.vmap(
            lambda f: bgr_to_gray(resize_bilinear(f.astype(jnp.float32), wh, ww))
        )(frames)
        pyrs = jax.vmap(
            lambda g: build_pyramid(g, config.lk.pyramid_levels)
        )(grays)

    if config.reference_compat and config.gftt.selection != "cv2exact":
        import dataclasses

        gftt_cfg = dataclasses.replace(config.gftt, selection="cv2exact")
    else:
        gftt_cfg = config.gftt
    with jax.named_scope("stage_gftt"):
        corners = jax.vmap(lambda g: good_features_to_track(g, gftt_cfg))(grays)

    # -- 2. batched LK + RANSAC over the K pairs ------------------------------
    pyr_prev = jax.tree.map(
        lambda c, p: jnp.concatenate([c[None], p[:-1]], axis=0),
        tuple(carry.pyr_prev), pyrs,
    )
    pts_prev = jnp.concatenate([carry.corners_prev[None], corners.points[:-1]])
    msk_prev = jnp.concatenate([carry.corners_mask[None], corners.mask[:-1]])

    with jax.named_scope("stage_lk"):
        tracked = jax.vmap(
            lambda pa, pb, p, m: lk_track(pa, pb, p, m, config.lk)
        )(pyr_prev, pyrs, pts_prev, msk_prev)
    with jax.named_scope("stage_fit"):
        ransac, t_rigid = jax.vmap(
            lambda s, d, st, kk: _fit_inter_frame(s, d, st, kk, config, center)
        )(pts_prev, tracked.points, tracked.status, k_ransac)

    have_prev = ns >= 1
    t_new = jnp.where((have_prev & ransac.valid)[:, None, None], t_rigid, eye)

    # -- 3. window state: one extended array, per-step sliding views ----------
    # ext[i] holds chronological transform T_{i - (w-1) + n0} (T_m maps frame
    # m-1 -> m); the window after chunk step j is ext[j+1 : j+w].  For the
    # very first frame (n0=0, j=0) streaming does not shift the window, but
    # the inserted un-pushed slot is identity + invalid, so every consumer
    # (masked smoothing, clipped t_pres lookups) sees identical values.
    ext = jnp.concatenate([carry.transforms, t_new], axis=0)        # (w-1+K,3,3)
    ext_v = jnp.concatenate([carry.tvalid, have_prev], axis=0)

    n_after = ns + 1
    length = jnp.minimum(n_after, w)
    num_tr = length - 1
    pres = jnp.where(length > future, length - future - 1, 0)
    pres_abs = jnp.where(n_after > future, n_after - future - 1, 0)

    with jax.named_scope("stage_smoothing"):
        def smooth_one(j, p, nt):
            t_win = jax.lax.dynamic_slice(ext, (j + 1, 0, 0), (w - 1, 3, 3))
            v_win = jax.lax.dynamic_slice(ext_v, (j + 1,), (w - 1,))
            return smoothing_homography(t_win, v_win, p, nt,
                                        config.reference_compat)

        h_smooth = jax.vmap(smooth_one)(idxs, pres, num_tr)

    # -- 4. frame ring update + presentation frames ---------------------------
    slots = jnp.mod(ns, w)
    frames_ring = carry.frames.at[slots].set(frames.astype(jnp.uint8))
    pres_slot = jnp.mod(pres_abs, w)
    pres_frames = frames_ring[pres_slot]                     # (K, Hf, Wf, C) u8

    # -- 5. lock transforms ----------------------------------------------------
    if config.reference_compat:
        # reference: TRANSLATION/ROTATION locks are no-ops (H_lock identity,
        # src/stabilizer.cpp:790); only ACCUMULATED accumulates.
        in_accum = mode == int(StabilizationMode.ACCUMULATED_FULL_LOCK)
    else:
        in_accum = mode in _ACCUM_MODES

    orb_ref, sift_ref = carry.orb_ref, carry.sift_ref
    lock_prev_h = carry.lock_prev_h
    lock_matches = jnp.zeros((k,), jnp.int32)

    if in_accum:
        with jax.named_scope("stage_lock"):
            active0 = carry.accum_active
            h0 = jnp.where(active0, carry.accum_h, eye)
            advanced = (n_after - 1 - future) >= 1
            # the anchor step itself never advances (lock_update's anchor
            # branch returns identity without multiplying)
            adv = advanced & (active0 | (idxs >= 1))
            tp = ext[jnp.clip(pres_abs - n0 + (w - 1), 0, w - 2 + k)]
            m_seq = jnp.where(adv[:, None, None], tp, eye)
            prefix = jax.lax.associative_scan(_mul_newest_left, m_seq, axis=0)
            accum_seq = jnp.matmul(prefix, h0, precision=_HIGH)
            h_lock = jax.vmap(_inv3x3)(accum_seq)
            accum_h_new = accum_seq[-1]
            accum_active_new = jnp.ones((), bool)
    elif mode in (int(StabilizationMode.ORB_FULL_LOCK),
                  int(StabilizationMode.SIFT_FULL_LOCK)):
        use_orb = mode == int(StabilizationMode.ORB_FULL_LOCK)
        h_lock, new_ref, lock_prev_h, lock_matches = _offline_registration(
            pres_frames, orb_ref if use_orb else sift_ref,
            carry.lock_prev_h, k_lock, config, use_orb,
        )
        if use_orb:
            orb_ref = new_ref
        else:
            sift_ref = new_ref
        accum_h_new = eye
        accum_active_new = jnp.zeros((), bool)
    else:  # GLOBAL_SMOOTHING: lock branch runs lock_clear every step
        h_lock = jnp.broadcast_to(eye, (k, 3, 3))
        accum_h_new = eye
        accum_active_new = jnp.zeros((), bool)

    # -- 6. rotation split + mode select ---------------------------------------
    lock_params, lock_ok = decompose_homography(h_lock, center)
    h_lock = jnp.where(lock_ok[:, None, None], h_lock, eye)
    if mode == int(StabilizationMode.GLOBAL_SMOOTHING):
        h_stab = h_smooth
    elif mode == int(StabilizationMode.TRANSLATION_LOCK):
        r_aug = jax.vmap(lambda th: _rotation_about(th, center))(lock_params.theta)
        h_stab = jnp.matmul(r_aug, h_lock, precision=_HIGH)
    elif mode == int(StabilizationMode.ROTATION_LOCK):
        h_stab = jax.vmap(lambda th: _rotation_about(-th, center))(lock_params.theta)
    else:
        h_stab = h_lock

    # -- 7. rescale + batched warp ---------------------------------------------
    with jax.named_scope("stage_warp"):
        h_scaled = h_stab.at[:, 0:2, 2].set(h_stab[:, 0:2, 2] / scale_factor)
        avg_color = 0.5 * jnp.mean(
            pres_frames.astype(jnp.float32), axis=(1, 2)
        )                                                     # (K, C)
        if config.ransac.motion_model == "homography":
            h_scaled = h_scaled.at[:, 2, 0:2].set(
                h_scaled[:, 2, 0:2] * scale_factor)
            warp = lambda f, h, c: warp_perspective(f, h, None, c)  # noqa: E731
        else:
            warp = warp_affine
        warped = jax.vmap(warp)(pres_frames, h_scaled, avg_color)
        warped_u8 = jnp.clip(jnp.round(warped), 0, 255).astype(jnp.uint8)

    # quirk #1: the very first frame is returned unstabilized
    is_first = ns == 0
    outputs = jnp.where(is_first[:, None, None, None],
                        frames.astype(jnp.uint8), warped_u8)
    out_valid = jnp.ones((k,), bool)

    new_carry = EngineCarry(
        frames=frames_ring,
        transforms=ext[k:],
        tvalid=ext_v[k:],
        pyr_prev=jax.tree.map(lambda p: p[-1], pyrs),
        corners_prev=corners.points[-1],
        corners_mask=corners.mask[-1],
        n=n0 + k,
        mode=carry.mode,
        accum_h=accum_h_new,
        accum_active=accum_active_new,
        orb_ref=orb_ref,
        sift_ref=sift_ref,
        lock_prev_h=lock_prev_h,
        last_h=h_stab[-1],
        last_inliers=ransac.num_inliers[-1],
        last_lock_matches=lock_matches[-1],
        key=carry.key,
    )
    return new_carry, (outputs, out_valid)


@functools.lru_cache(maxsize=32)
def make_offline_fn(config: StabilizerConfig) -> Callable:
    """Jitted (carry, frames (K, Hf, Wf, C)) -> (carry, (outputs, valid)) with
    batched per-frame stages; K is static per call shape.  The carry is
    donated (the frame ring updates in place)."""
    return jax.jit(
        functools.partial(offline_chunk_step, config=config),
        donate_argnums=0,
    )


@functools.lru_cache(maxsize=32)
def make_offline_batched_fn(config: StabilizerConfig) -> Callable:
    """Stream-batched offline pipeline: (carry_batch, frames (S, K, Hf, Wf,
    C)) -> (carry_batch, (outputs, valid)) — vmap over streams OF the
    K-frame chunked pipeline, so every kernel sees S*K parallel work items
    (BASELINE config 5 at maximum utilization)."""
    step = functools.partial(offline_chunk_step, config=config)
    return jax.jit(jax.vmap(step), donate_argnums=0)


def stabilize_clip_offline(
    carry: EngineCarry,
    frames: jax.Array,
    config: StabilizerConfig,
    chunk: int = 16,
) -> Tuple[EngineCarry, jax.Array]:
    """Host-side driver: run a (T, Hf, Wf, C) clip through the offline
    pipeline in ``chunk``-frame dispatches.  Returns (carry, outputs)."""
    step = make_offline_fn(config)
    t = frames.shape[0]
    outs = []
    i = 0
    while i < t:
        j = min(i + chunk, t)
        # a trailing partial chunk just compiles once more for its own K
        carry, (out, _) = step(carry, frames[i:j])
        outs.append(out)
        i = j
    return carry, jnp.concatenate(outs, axis=0)
