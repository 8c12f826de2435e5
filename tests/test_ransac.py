"""Tests for the masked similarity fit and vmapped-hypothesis RANSAC."""

import jax
import jax.numpy as jnp
import numpy as np

from video_stabilization.config import RansacConfig
from video_stabilization.motion import (
    estimate_similarity_ransac,
    fit_similarity_masked,
    similarity_from_2pt,
)
from video_stabilization.motion.similarity import transform_points


def make_similarity(s, theta, tx, ty):
    a, b = s * np.cos(theta), s * np.sin(theta)
    return np.array([[a, -b, tx], [b, a, ty], [0, 0, 1]], np.float32)


class TestSimilarityFit:
    def test_exact_recovery(self, rng):
        h_true = make_similarity(1.1, 0.2, 5.0, -3.0)
        src = rng.uniform(0, 640, (100, 2)).astype(np.float32)
        dst = transform_points(jnp.asarray(h_true), jnp.asarray(src))
        h, valid = fit_similarity_masked(src, dst, jnp.ones(100))
        assert bool(valid)
        np.testing.assert_allclose(h, h_true, atol=1e-3)

    def test_masked_outliers_ignored(self, rng):
        h_true = make_similarity(0.95, -0.1, -8.0, 2.0)
        src = rng.uniform(0, 640, (100, 2)).astype(np.float32)
        dst = np.array(transform_points(jnp.asarray(h_true), jnp.asarray(src)))
        dst[80:] += rng.uniform(50, 100, (20, 2))  # corrupt 20 points
        w = np.ones(100, np.float32)
        w[80:] = 0.0
        h, valid = fit_similarity_masked(src, jnp.asarray(dst), jnp.asarray(w))
        assert bool(valid)
        np.testing.assert_allclose(h, h_true, atol=1e-3)

    def test_degenerate_coincident_points(self):
        src = jnp.zeros((10, 2))
        dst = jnp.ones((10, 2))
        h, valid = fit_similarity_masked(src, dst, jnp.ones(10))
        assert not bool(valid)

    def test_two_point_exact(self, rng):
        h_true = make_similarity(1.3, 0.7, 12.0, 4.0)
        src = rng.uniform(0, 100, (2, 2)).astype(np.float32)
        dst = transform_points(jnp.asarray(h_true), jnp.asarray(src))
        h, valid = similarity_from_2pt(src, dst)
        assert bool(valid)
        np.testing.assert_allclose(h, h_true, atol=1e-3)


class TestRansac:
    def test_recovers_under_outliers(self, rng):
        h_true = make_similarity(1.0, 0.05, 3.0, -2.0)
        n = 256
        src = rng.uniform(0, 640, (n, 2)).astype(np.float32)
        dst = np.array(transform_points(jnp.asarray(h_true), jnp.asarray(src)))
        dst += rng.normal(0, 0.3, dst.shape)  # inlier noise
        n_out = 80
        out_idx = rng.choice(n, n_out, replace=False)
        dst[out_idx] = rng.uniform(0, 640, (n_out, 2))  # 31% outliers
        mask = np.ones(n, bool)

        res = estimate_similarity_ransac(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
            jax.random.key(0),
        )
        assert bool(res.valid)
        assert int(res.num_inliers) > 120
        np.testing.assert_allclose(res.h, h_true, atol=0.15)

    def test_too_few_points_identity(self, rng):
        src = rng.uniform(0, 100, (64, 2)).astype(np.float32)
        dst = src + 1.0
        mask = np.zeros(64, bool)
        mask[:5] = True  # below min_points=10
        res = estimate_similarity_ransac(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), jax.random.key(1)
        )
        assert not bool(res.valid)
        np.testing.assert_allclose(res.h, np.eye(3))
        assert int(res.num_inliers) == 0

    def test_jit(self, rng):
        h_true = make_similarity(1.0, -0.03, 1.0, 1.0)
        src = rng.uniform(0, 640, (128, 2)).astype(np.float32)
        dst = transform_points(jnp.asarray(h_true), jnp.asarray(src))
        f = jax.jit(
            lambda s, d, m, k: estimate_similarity_ransac(s, d, m, k, RansacConfig())
        )
        res = f(src, dst, jnp.ones(128, bool), jax.random.key(2))
        assert bool(res.valid)
        np.testing.assert_allclose(res.h, h_true, atol=5e-2)


class TestMotionModelRefit:
    """LO-RANSAC refit_fn hook: similarity hypotheses + configured-model
    refinement (models.motion_models wired via RansacConfig.motion_model)."""

    def _cloud(self, rng, h_true, n=120, outliers=20):
        src = rng.uniform(20, 300, (n, 2)).astype(np.float32)
        ones = np.ones((n, 1), np.float32)
        p = np.concatenate([src, ones], 1) @ h_true.T
        dst = (p[:, :2] / p[:, 2:]).astype(np.float32)
        dst[:outliers] += rng.uniform(30, 80, (outliers, 2))
        return jnp.asarray(src), jnp.asarray(dst)

    def test_affine_refit_recovers_affine(self):
        from video_stabilization.models.motion_models import (
            MotionModel, fit_motion,
        )

        rng = np.random.default_rng(0)
        h_true = np.array([[1.02, 0.05, 4.0], [-0.03, 0.97, -2.0], [0, 0, 1.0]])
        src, dst = self._cloud(rng, h_true)
        center = jnp.array([160.0, 160.0])
        res = estimate_similarity_ransac(
            src, dst, jnp.ones(src.shape[0], bool), jax.random.key(0),
            RansacConfig(num_hypotheses=256),
            refit_fn=lambda s, d, w: fit_motion(MotionModel.AFFINE, s, d, w, center),
        )
        assert bool(res.valid)
        np.testing.assert_allclose(np.asarray(res.h), h_true, atol=5e-2)

    def test_homography_refit_recovers_projective(self):
        from video_stabilization.models.motion_models import (
            MotionModel, fit_motion,
        )

        rng = np.random.default_rng(1)
        h_true = np.array([
            [1.0, 0.02, 5.0], [-0.02, 1.0, 3.0], [1e-4, -5e-5, 1.0]
        ])
        src, dst = self._cloud(rng, h_true, outliers=10)
        center = jnp.array([160.0, 160.0])
        res = estimate_similarity_ransac(
            src, dst, jnp.ones(src.shape[0], bool), jax.random.key(2),
            RansacConfig(num_hypotheses=256, inlier_threshold=5.0),
            refit_fn=lambda s, d, w: fit_motion(
                MotionModel.HOMOGRAPHY, s, d, w, center),
        )
        assert bool(res.valid)
        np.testing.assert_allclose(np.asarray(res.h), h_true, atol=5e-2, rtol=0.2)
