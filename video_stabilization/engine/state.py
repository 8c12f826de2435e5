"""Engine carry: the explicit, device-resident state pytree.

The reference keeps its state as hidden mutable members of the Stabilizer
object (include/stabilizer.hpp:430-459: frame/transform deques, previous
gray + points, accumulated transform, lock reference features).  Here that
state is one explicit NamedTuple of fixed-shape arrays that lives in device
memory across frames — the jitted step consumes and returns it, vmap batches it
over streams, and (being a pytree of arrays) it doubles as the natural
checkpoint unit (SURVEY.md §5.4).

Layout decisions:
- **Frames ring buffer** (W slots, uint8, full resolution): a circular
  buffer indexed by absolute frame counter modulo W — one
  dynamic_update_slice write per step, no shifting of ~100 frames in memory.
  Only needed because output is delayed by ``future_frames`` (the engine
  presents frame n - future - 1 when frame n arrives).
- **Transforms** (W-1 slots, newest last): shifted by one slot per step.
  At 104 x 3 x 3 f32 this is ~4 KB — the roll costs nothing and keeps the
  smoothing scan's chronology trivial.
- **Previous-frame pyramid and corners** are carried so each frame's
  pyramid/GFTT is computed exactly once (the reference recomputes pyramids
  inside calcOpticalFlowPyrLK for both frames every call).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from video_stabilization.config import StabilizerConfig


class RegistrationRef(NamedTuple):
    """Reference-frame features for the ORB/SIFT registration locks
    (reference state: referenceKeypoints_/referenceDescriptors_,
    include/stabilizer.hpp:430-459)."""

    points: jax.Array     # (N, 2) f32 keypoint locations (working res)
    desc: jax.Array       # (N, D) descriptor matrix (int8 ORB / f32 SIFT)
    mask: jax.Array       # (N,) bool
    gray: jax.Array       # (wh, ww) f32 preprocessed reference gray (for ECC)
    is_set: jax.Array     # () bool — reference captured


class EngineCarry(NamedTuple):
    # Temporal window -------------------------------------------------------
    frames: jax.Array       # (W, Hf, Wf, C) uint8, circular by abs index % W
    transforms: jax.Array   # (W-1, 3, 3) f32, newest at index W-2
    tvalid: jax.Array       # (W-1,) bool — slot holds a real transform
    # Previous-frame features ----------------------------------------------
    pyr_prev: Tuple[jax.Array, ...]  # working-res gray pyramid
    corners_prev: jax.Array          # (N, 2) f32
    corners_mask: jax.Array          # (N,) bool
    # Counters / mode -------------------------------------------------------
    n: jax.Array            # () int32 — frames ingested so far
    mode: jax.Array         # () int32 — StabilizationMode value
    # Accumulated-lock state (reference: accumulatedTransform_) -------------
    accum_h: jax.Array      # (3, 3) f32
    accum_active: jax.Array  # () bool — anchor captured
    # Registration-lock state ------------------------------------------------
    orb_ref: RegistrationRef
    sift_ref: RegistrationRef
    # Last good lock transform — the reference's sticky fallback
    # (src/stabilizer.cpp:446) but per-instance, not a process-wide static.
    lock_prev_h: jax.Array  # (3, 3) f32
    # Last applied stabilization transform (working res) — observability /
    # drift benchmarking (the reference exposes nothing; SURVEY.md §5.5).
    last_h: jax.Array       # (3, 3) f32
    # RANSAC inlier count of the last inter-frame fit — the match-quality
    # telemetry the reference logs per frame (src/stabilizer.cpp:667-702).
    last_inliers: jax.Array  # () int32
    # Good-match count of the last ORB/SIFT registration (post ratio /
    # mean-distance filter; reference logs at src/stabilizer.cpp:667-668,
    # 698-702).  0 outside registration modes / before the reference is set.
    last_lock_matches: jax.Array  # () int32
    # PRNG for RANSAC hypothesis sampling -----------------------------------
    key: jax.Array


def init_carry(config: StabilizerConfig, mode: int, key: jax.Array) -> EngineCarry:
    w = config.total_window
    hf, wf, c = config.frame_height, config.frame_width, config.channels
    wh, ww = config.working_size
    n_feat = config.gftt.max_features
    levels = config.lk.pyramid_levels

    pyr = []
    h_l, w_l = wh, ww
    for _ in range(levels + 1):
        pyr.append(jnp.zeros((h_l, w_l), jnp.float32))
        h_l, w_l = -(-h_l // 2), -(-w_l // 2)

    def empty_ref(n_kp: int, desc_dim: int, desc_dtype) -> RegistrationRef:
        return RegistrationRef(
            points=jnp.zeros((n_kp, 2), jnp.float32),
            desc=jnp.zeros((n_kp, desc_dim), desc_dtype),
            mask=jnp.zeros((n_kp,), bool),
            gray=jnp.zeros((wh, ww), jnp.float32),
            is_set=jnp.zeros((), bool),
        )

    return EngineCarry(
        frames=jnp.zeros((w, hf, wf, c), jnp.uint8),
        transforms=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (w - 1, 3, 3)),
        tvalid=jnp.zeros((w - 1,), bool),
        pyr_prev=tuple(pyr),
        corners_prev=jnp.zeros((n_feat, 2), jnp.float32),
        corners_mask=jnp.zeros((n_feat,), bool),
        n=jnp.zeros((), jnp.int32),
        mode=jnp.asarray(mode, jnp.int32),
        accum_h=jnp.eye(3, dtype=jnp.float32),
        accum_active=jnp.zeros((), bool),
        orb_ref=empty_ref(config.orb.max_features, 256, jnp.int8),
        sift_ref=empty_ref(config.sift.max_features, 128, jnp.float32),
        lock_prev_h=jnp.eye(3, dtype=jnp.float32),
        last_h=jnp.eye(3, dtype=jnp.float32),
        last_inliers=jnp.zeros((), jnp.int32),
        last_lock_matches=jnp.zeros((), jnp.int32),
        key=key,
    )
