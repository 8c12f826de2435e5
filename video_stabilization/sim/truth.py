"""Analytic ground truth from simulator trajectories, and the drift metric.

The simulator renders a floor plane, so the true inter-frame motion is an
exact homography (``inter_frame_homography``).  These helpers turn a
trajectory into the transform the engine should apply to each frame, and
measure how far the engine's transforms are from it.
"""

from __future__ import annotations

import numpy as np


def corner_drift(hs_a, hs_b, ww, wh, skip=5):
    """Mean corner displacement (px, working res) between two per-frame
    transform sequences — the BASELINE drift metric.  The first ``skip``
    pairs are left out."""
    c = np.array([[0, 0, 1], [ww, 0, 1], [ww, wh, 1], [0, wh, 1]], float).T
    drifts = []
    for ha, hb in zip(hs_a[skip:], hs_b[skip:]):
        pa = ha @ c
        pa = pa[:2] / pa[2]
        pb = hb @ c
        pb = pb[:2] / pb[2]
        drifts.append(np.abs(pa - pb).mean())
    return float(np.mean(drifts))


def _inter_frame(traj, n_frames, wh, ww):
    """float64 (n_frames-1, 3, 3): H_i maps frame i pixels to frame i+1."""
    import jax

    from video_stabilization.sim.camera_engine import inter_frame_homography

    pair = jax.jit(jax.vmap(
        lambda pa, pb: inter_frame_homography(pa, pb, wh, ww)))
    a = jax.tree.map(lambda x: x[:n_frames - 1], traj)
    b = jax.tree.map(lambda x: x[1:n_frames], traj)
    return np.asarray(pair(a, b), np.float64)


def analytic_smoothing_truth(traj, n_frames, wh, ww, past, future):
    """Ground-truth smoothing transforms: analytic inter-frame homographies
    at working resolution run through the (corrected) smoothing formula.
    Entry n-1 is the transform after ingesting n frames."""
    import jax
    import jax.numpy as jnp

    from video_stabilization.engine.smoothing import smoothing_homography

    h_true = list(_inter_frame(traj, n_frames, wh, ww))
    smooth = jax.jit(lambda t, v, p, n: smoothing_homography(
        t, v, p, n, reference_compat=False))

    wm1 = past + future
    qs = [np.eye(3)]                       # first frame: no transforms yet
    for n in range(2, n_frames + 1):       # after ingesting frame n
        length = min(n, wm1 + 1)
        num_tr = length - 1
        window = h_true[n - 1 - num_tr : n - 1]
        arr = np.broadcast_to(np.eye(3), (wm1, 3, 3)).copy()
        arr[wm1 - num_tr:] = window
        tvalid = np.zeros(wm1, bool)
        tvalid[wm1 - num_tr:] = True
        pres = length - future - 1 if length > future else 0
        q = smooth(jnp.asarray(arr, jnp.float32), jnp.asarray(tvalid),
                   jnp.asarray(pres), jnp.asarray(num_tr))
        qs.append(np.asarray(q, np.float64))
    return qs


def analytic_lock_truth(traj, n_frames, wh, ww, future):
    """Ground-truth lock transforms for a lock anchored on frame 0 (the
    accumulated lock and the ORB/SIFT registration locks): after ingesting
    n frames the presentation frame is p = max(n - future - 1, 0) and the
    lock maps it back onto frame 0, inv(H_{0->p}).  Entry n-1 is the
    transform after ingesting n frames."""
    h_true = _inter_frame(traj, n_frames, wh, ww)
    chain = [np.eye(3)]
    for h in h_true:
        nxt = h @ chain[-1]
        chain.append(nxt / nxt[2, 2])
    out = []
    for n in range(1, n_frames + 1):
        p = max(n - future - 1, 0)
        out.append(np.linalg.inv(chain[p]))
    return out
