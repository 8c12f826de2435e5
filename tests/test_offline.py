"""Offline batched pipeline (engine/offline.py) vs the streaming step.

The offline pipeline batches the per-pair estimation over frames; it must be
*semantically identical* to feeding the same frames through
``stabilize_step`` one at a time — warm-up, quirks, lock anchoring, sticky
fallbacks, and (via fold_in frame keys) the same RANSAC randomness.  Outputs
are uint8 frames, so after float-order differences from batching we assert
near-bit-equality (tiny tolerance in transform space, <=1 gray-level in
pixels for a tiny fraction of pixels).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.config import StabilizationMode
from video_stabilization.engine import (
    init_carry,
    make_offline_fn,
    make_scan_fn,
    make_step_fn,
    stabilize_clip_offline,
)

from test_engine import FH, FW, footage, small_config  # noqa: F401


def _run_streaming(cfg, mode, frames):
    step = make_step_fn(cfg)
    carry = init_carry(cfg, int(mode), jax.random.key(7))
    outs, hs = [], []
    for f in frames:
        carry, (out, _) = step(carry, jnp.asarray(f))
        outs.append(np.asarray(out))
        hs.append(np.asarray(carry.last_h))
    return carry, np.stack(outs), np.stack(hs)


def _run_offline(cfg, mode, frames, chunk):
    cfg_off = dataclasses.replace(cfg, static_mode=int(mode))
    step = make_offline_fn(cfg_off)
    carry = init_carry(cfg_off, int(mode), jax.random.key(7))
    outs = []
    n = len(frames)
    i = 0
    while i < n:
        j = min(i + chunk, n)
        carry, (out, _) = step(carry, jnp.asarray(frames[i:j]))
        outs.append(np.asarray(out))
        i = j
    return carry, np.concatenate(outs, axis=0)


def _assert_frames_close(a, b, max_frac_offby1=0.02):
    """uint8 outputs: allow a small fraction of +-1 rounding flips from
    float-order differences between batched and sequential programs."""
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1, f"max pixel diff {diff.max()}"
    frac = (diff > 0).mean()
    assert frac <= max_frac_offby1, f"{frac:.4f} of pixels differ"


@pytest.mark.parametrize("mode,chunk", [
    (StabilizationMode.GLOBAL_SMOOTHING, 5),
    (StabilizationMode.ACCUMULATED_FULL_LOCK, 6),
    (StabilizationMode.TRANSLATION_LOCK, 4),
])
def test_offline_matches_streaming(footage, mode, chunk):  # noqa: F811
    cfg = small_config(past=6, future=3)
    n = 17   # not a chunk multiple: exercises the trailing partial chunk
    c_s, outs_s, hs_s = _run_streaming(cfg, mode, footage[:n])
    c_o, outs_o = _run_offline(cfg, mode, footage[:n], chunk)

    _assert_frames_close(outs_o, outs_s)
    np.testing.assert_allclose(np.asarray(c_o.last_h), np.asarray(c_s.last_h),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(c_o.transforms),
                               np.asarray(c_s.transforms), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(c_o.tvalid),
                                  np.asarray(c_s.tvalid))
    assert int(c_o.n) == int(c_s.n) == n
    np.testing.assert_allclose(np.asarray(c_o.accum_h),
                               np.asarray(c_s.accum_h), atol=1e-4)
    np.testing.assert_allclose(np.asarray(c_o.corners_prev),
                               np.asarray(c_s.corners_prev), atol=1e-3)


def test_offline_orb_lock_matches_streaming(footage):  # noqa: F811
    cfg = small_config(past=4, future=2)
    mode = StabilizationMode.ORB_FULL_LOCK
    n = 10
    c_s, outs_s, _ = _run_streaming(cfg, mode, footage[:n])
    c_o, outs_o = _run_offline(cfg, mode, footage[:n], chunk=4)
    # registration involves long dependent chains (descriptor bits ->
    # matches -> RANSAC); batched vs sequential float-order differences can
    # flip individual descriptor bits, so compare in transform space with a
    # small pixel tolerance via corner displacement
    ha, hb = np.asarray(c_o.last_h), np.asarray(c_s.last_h)
    corners = np.array([[0, 0, 1], [FW, 0, 1], [FW, FH, 1], [0, FH, 1]],
                       float).T
    pa = (ha @ corners)[:2] / (ha @ corners)[2]
    pb = (hb @ corners)[:2] / (hb @ corners)[2]
    assert np.abs(pa - pb).max() < 0.5, f"lock corner mismatch\n{ha}\n{hb}"
    assert bool(c_o.orb_ref.is_set) and bool(c_s.orb_ref.is_set)
    np.testing.assert_allclose(np.asarray(c_o.orb_ref.points),
                               np.asarray(c_s.orb_ref.points), atol=1e-3)


def test_offline_requires_static_mode(footage):  # noqa: F811
    cfg = small_config()
    carry = init_carry(cfg, 0, jax.random.key(0))
    with pytest.raises(ValueError, match="static_mode"):
        stabilize_clip_offline(carry, jnp.asarray(footage[:4]), cfg)


def test_offline_chunk_exceeding_window_raises(footage):  # noqa: F811
    cfg = dataclasses.replace(
        small_config(past=2, future=1),
        static_mode=int(StabilizationMode.GLOBAL_SMOOTHING))
    carry = init_carry(cfg, 0, jax.random.key(0))
    fn = make_offline_fn(cfg)
    with pytest.raises(ValueError, match="exceeds temporal window"):
        fn(carry, jnp.asarray(footage[:6]))   # window = 4 < 6


def test_scan_still_matches_step_after_fold_in_keys(footage):  # noqa: F811
    """Key derivation moved from split-chains to fold_in(n); the scan path
    must still be bit-identical to the per-frame path."""
    cfg = small_config(past=4, future=2)
    n = 8
    c_s, outs_s, _ = _run_streaming(cfg, StabilizationMode.GLOBAL_SMOOTHING,
                                    footage[:n])
    scan = make_scan_fn(cfg)
    carry = init_carry(cfg, int(StabilizationMode.GLOBAL_SMOOTHING),
                       jax.random.key(7))
    carry, (outs, _) = scan(carry, jnp.asarray(footage[:n]))
    np.testing.assert_array_equal(np.asarray(outs), outs_s)


def test_rotated_accumulated_lock_renders_like_single_warp(footage):  # noqa: F811
    """A stream whose accumulated lock sits 25 degrees off renders, through
    the stream-batched offline pipeline, what the single-frame warp gives
    for the transform it used, and no output frame is blank."""
    from video_stabilization.engine import make_offline_batched_fn
    from video_stabilization.ops.warp import warp_affine
    from video_stabilization.parallel import init_batched_carry

    mode = StabilizationMode.ACCUMULATED_FULL_LOCK
    cfg = dataclasses.replace(small_config(past=2, future=1),
                              static_mode=int(mode))
    k = 4
    fn = make_offline_batched_fn(cfg)
    carry = init_batched_carry(cfg, 2, int(mode), jax.random.key(0))
    clip = jnp.asarray(np.stack([footage[:3 * k], footage[:3 * k]]))
    for i in range(2):                     # fill the window, anchor the lock
        carry, _ = fn(carry, clip[:, i * k:(i + 1) * k])

    # pre-rotate stream 1's accumulated transform by 25 degrees
    th = np.deg2rad(25.0)
    big_rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                        [np.sin(th), np.cos(th), 0.0],
                        [0.0, 0.0, 1.0]], np.float32)
    carry = carry._replace(accum_h=carry.accum_h.at[1].set(big_rot))
    carry, (outs, _) = fn(carry, clip[:, 2 * k:])
    outs = np.asarray(outs)
    assert all(outs[s, j].std() > 5.0 for s in range(2) for j in range(k))

    # stream 1's last output, rendered again by the single-frame warp
    h = np.asarray(carry.last_h[1]).copy()
    rot = np.degrees(np.arctan2(h[1, 0], h[0, 0]))
    assert abs(abs(rot) - 25.0) < 5.0, rot
    h[0:2, 2] /= cfg.scale_factor
    pres = jnp.asarray(footage[3 * k - cfg.future_frames - 1], jnp.float32)
    avg = 0.5 * jnp.mean(pres, axis=(0, 1))
    single = warp_affine(pres, jnp.asarray(h), avg)
    single_u8 = np.asarray(jnp.clip(jnp.round(single), 0, 255).astype(jnp.uint8))
    diff = np.abs(outs[1, -1].astype(np.int16) - single_u8.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
