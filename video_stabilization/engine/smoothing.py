"""Temporal-window trajectory smoothing — the GLOBAL_SMOOTHING brain.

Implements the moving-average smoothing homography Q_t of
docs/math-overview.md ("Smoothing camera motion") as two fixed-length
masked ``associative_scan`` product chains over the transform window
(log-depth batched 3x3 matmuls; reference: src/stabilizer.cpp:793-852):

    past side:    P_j = T[p-j]^-1 · P_{j-1}         (maps frame p -> p-j)
    future side:  F_j = T[p+j] · F_{j-1}            (maps frame p -> p+j+1)
    Q = ( Σ_j P_j + [I] + Σ_j F_j ) / count

Masked lanes (outside the valid window) contribute nothing; shapes stay
static for any warm-up state.

The reference has three documented quirks (SURVEY.md appendix), replicated
only when ``reference_compat`` is set:
  1. future loop bound excludes the NEWEST transform (src/stabilizer.cpp:826);
  2. the presentation frame's identity term is omitted from the average
     (:841-843 divides by neighbour count only);
  3. future-side chaining multiplies on the RIGHT (H_accum·T, :834), i.e.
     T[p]·T[p+1]·…, the reverse of the math doc's product order (benign for
     near-commuting rigid transforms, but not the documented formula).
With ``reference_compat=False`` the math-overview formula is implemented
exactly: all future transforms, identity term included, left-chaining.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from video_stabilization.ops.warp import _inv3x3


def smoothing_homography(
    transforms: jax.Array,
    tvalid: jax.Array,
    presentation_idx: jax.Array,
    num_transforms: jax.Array,
    reference_compat: bool = False,
) -> jax.Array:
    """Compute the smoothing homography Q for the presentation frame.

    Args:
      transforms: (W-1, 3, 3) chronological inter-frame transforms, newest at
        the last slot; slot i maps window-frame i -> i+1 ... but only the last
        ``num_transforms`` slots are real (warm-up).
      tvalid: (W-1,) validity of each slot.
      presentation_idx: () int32 — chronological window index of the
        presentation frame (0-based over the *valid* suffix of the window).
      num_transforms: () int32 — count of valid transforms (= L-1 for L
        window frames).
      reference_compat: replicate the reference's three quirks bit-for-bit.

    Returns (3, 3) f32 smoothing homography (identity when no neighbours).
    """
    wm1 = transforms.shape[0]
    dtype = transforms.dtype

    # Chronological transform i (0-based over valid suffix) lives at array
    # slot (wm1 - num_transforms + i).
    base = wm1 - num_transforms
    p = presentation_idx
    eye = jnp.eye(3, dtype=dtype)

    # Both chains are cumulative 3x3 matrix products; a lax.scan runs them as
    # ~2(W-1) *sequential* micro-matmuls (hundreds of dependent tiny ops at
    # the reference's 106-frame window).  Masked lanes multiply by identity,
    # so each chain is an ``associative_scan`` — log2(W) batched (W-1, 3, 3)
    # matmul rounds (the BASELINE "fused lax.scan" north star, done one
    # better; regrouping changes float results by ~1e-6 on rigid products).
    def chrono_batch(idx):
        # (W-1,) chronological indices -> (W-1, 3, 3) transforms + validity
        slot = jnp.clip(base + idx, 0, wm1 - 1)
        t = transforms[slot]
        v = tvalid[slot] & (idx >= 0) & (idx < num_transforms)
        return t, v

    def mul_lr(x, y):   # cumulative left-multiplication: result_j = A_j ... A_1
        return jnp.matmul(y, x, precision=jax.lax.Precision.HIGHEST)

    def mul_rl(x, y):   # cumulative right-multiplication: result_j = A_1 ... A_j
        return jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST)

    # --- past side: j = 1 .. wm1, accum_j = T[p-j]^-1 · accum_{j-1} ----------
    t_past, v_past = chrono_batch(p - jnp.arange(1, wm1 + 1))
    a_past = jnp.where(v_past[:, None, None], jax.vmap(_inv3x3)(t_past), eye)
    past_terms = jax.lax.associative_scan(mul_lr, a_past)
    past_valid = v_past

    # --- future side ---------------------------------------------------------
    # uses chronological transforms p, p+1, ...; bound excludes the newest
    # transform in compat mode (reference quirk #1); compat chains on the
    # RIGHT (reference quirk #3, src/stabilizer.cpp:834).
    last_allowed = num_transforms - (2 if reference_compat else 1)
    fidx = p + jnp.arange(0, wm1)
    t_fut, v_fut = chrono_batch(fidx)
    v_fut = v_fut & (fidx <= last_allowed)
    b_fut = jnp.where(v_fut[:, None, None], t_fut, eye)
    future_terms = jax.lax.associative_scan(
        mul_rl if reference_compat else mul_lr, b_fut
    )
    future_valid = v_fut

    mask_p = past_valid[:, None, None]
    mask_f = future_valid[:, None, None]
    h_sum = (
        jnp.sum(jnp.where(mask_p, past_terms, 0.0), axis=0)
        + jnp.sum(jnp.where(mask_f, future_terms, 0.0), axis=0)
    )
    count = jnp.sum(past_valid) + jnp.sum(future_valid)

    if not reference_compat:
        # identity term for the presentation frame itself (quirk #2 fixed)
        h_sum = h_sum + eye
        count = count + 1

    have_any = count > 0
    h_avg = h_sum / jnp.maximum(count, 1).astype(dtype)
    finite = jnp.all(jnp.isfinite(h_avg))
    return jnp.where(have_any & finite, h_avg, eye)
