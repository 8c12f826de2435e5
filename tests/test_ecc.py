"""ECC refinement tests vs known transforms and cv2.findTransformECC."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from video_stabilization.ops.ecc import ecc_refine_euclidean
from video_stabilization.sim import (
    DEFAULT_APP_PARAMS,
    make_default_texture,
    render_frame,
)

H, W = 180, 320


def sim_gray():
    tex = make_default_texture(jax.random.key(0), size=256)
    f = np.asarray(render_frame(tex, DEFAULT_APP_PARAMS, H, W))
    g = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).astype(np.float32)
    return cv2.GaussianBlur(g, (5, 5), 1.0)


def euclidean(theta, tx, ty):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, tx], [s, c, ty], [0, 0, 1]], np.float32)


class TestECC:
    def test_refines_coarse_estimate(self):
        ref = sim_gray()
        h_true = euclidean(0.02, 3.0, -2.0)       # cur = warp of ref by h_true
        cur = cv2.warpPerspective(ref, h_true.astype(np.float64), (W, H))
        # coarse init off by ~1 px / 0.5 degrees
        h_init = euclidean(0.02 + 0.008, 3.9, -1.2)

        res = ecc_refine_euclidean(
            jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(h_init), max_iters=50
        )
        assert bool(res.valid)
        # corner error of refined vs true mapping
        c = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], float).T
        pe = np.asarray(res.h, float) @ c
        pt = h_true.astype(float) @ c
        err = np.abs(pe[:2] / pe[2] - pt[:2] / pt[2]).mean()
        init_err = np.abs(h_init @ c - pt)[:2].mean()
        assert err < 0.3
        assert err < 0.3 * init_err
        assert float(res.rho) > 0.95

    def test_identity_stays_near_identity(self):
        ref = sim_gray()
        res = ecc_refine_euclidean(
            jnp.asarray(ref), jnp.asarray(ref), jnp.eye(3), max_iters=20
        )
        np.testing.assert_allclose(np.asarray(res.h), np.eye(3), atol=5e-2)
        assert float(res.rho) > 0.999

    def test_comparable_to_cv2(self):
        ref = sim_gray()
        h_true = euclidean(-0.015, -2.0, 1.5)
        cur = cv2.warpPerspective(ref, h_true.astype(np.float64), (W, H))
        h_init = euclidean(0.0, 0.0, 0.0)

        res = ecc_refine_euclidean(
            jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(h_init), max_iters=80
        )
        warp0 = np.eye(2, 3, dtype=np.float32)
        try:
            _, cv_warp = cv2.findTransformECC(
                ref, cur, warp0, cv2.MOTION_EUCLIDEAN,
                (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 80, 1e-4),
                None, 5,
            )
            cv_h = np.vstack([cv_warp, [0, 0, 1]])
        except cv2.error:
            cv_h = None

        c = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], float).T
        pt = h_true.astype(float) @ c
        ours = np.abs((np.asarray(res.h, float) @ c - pt)[:2]).mean()
        assert ours < 0.5
        if cv_h is not None:
            theirs = np.abs((cv_h.astype(float) @ c - pt)[:2]).mean()
            assert ours < max(2.0 * theirs, 0.5)

    def test_jit(self):
        ref = sim_gray()
        f = jax.jit(lambda r, c, h: ecc_refine_euclidean(r, c, h, max_iters=10))
        res = f(jnp.asarray(ref), jnp.asarray(ref), jnp.eye(3))
        assert np.isfinite(np.asarray(res.h)).all()
