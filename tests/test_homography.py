"""Math-core tests: decompose/compose round trips, QR, scale removal.

Mirrors the reference's in-code numerical self-verification
(src/stabilizer.cpp:1409-1423 QR self-check, :1518-1519 k2≈1/k1 assert) as a
real test suite, plus uniqueness/round-trip properties from
docs/math-overview.md ("is unique if s is chosen positive").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.motion import (
    HomographyParams,
    compose_homography,
    decompose_homography,
    identity_homography,
    qr_2x2,
    remove_isotropic_scale,
)

CENTER = jnp.array([320.0, 180.0])


def random_params(rng, n, perspective=True):
    s = np.exp(rng.uniform(-0.3, 0.3, n))
    theta = rng.uniform(-np.pi / 2, np.pi / 2, n)
    k = np.exp(rng.uniform(-0.2, 0.2, n))
    delta = rng.uniform(-0.2, 0.2, n)
    t = rng.uniform(-50, 50, (n, 2))
    v = rng.uniform(-1e-4, 1e-4, (n, 2)) if perspective else np.zeros((n, 2))
    return HomographyParams(
        scale=jnp.asarray(s, jnp.float32),
        theta=jnp.asarray(theta, jnp.float32),
        k=jnp.asarray(k, jnp.float32),
        delta=jnp.asarray(delta, jnp.float32),
        t=jnp.asarray(t, jnp.float32),
        v=jnp.asarray(v, jnp.float32),
    )


class TestQR2x2:
    def test_reconstruction_and_orthogonality(self, rng):
        a = jnp.asarray(rng.normal(size=(64, 2, 2)), jnp.float32)
        # bias away from singularity
        a = a + 2.0 * jnp.sign(jnp.linalg.det(a))[..., None, None] * jnp.eye(2)
        q, r, valid = qr_2x2(a)
        assert bool(jnp.all(valid))
        np.testing.assert_allclose(q @ r, a, atol=1e-5)
        qtq = jnp.einsum("...ji,...jk->...ik", q, q)
        np.testing.assert_allclose(qtq, np.broadcast_to(np.eye(2), qtq.shape), atol=1e-5)
        # upper-triangular with positive diagonal
        assert bool(jnp.all(r[..., 1, 0] == 0))
        assert bool(jnp.all(r[..., 0, 0] > 0))
        assert bool(jnp.all(r[..., 1, 1] > 0))

    def test_singular_flagged(self):
        a = jnp.array([[[1.0, 2.0], [2.0, 4.0]]])
        _, _, valid = qr_2x2(a)
        assert not bool(valid[0])


class TestDecomposeCompose:
    def test_roundtrip_params(self, rng):
        """params -> H -> params must be the identity map (uniqueness)."""
        p = random_params(rng, 128)
        h = compose_homography(p, CENTER)
        p2, valid = decompose_homography(h, CENTER)
        assert bool(jnp.all(valid))
        np.testing.assert_allclose(p2.scale, p.scale, rtol=2e-5)
        np.testing.assert_allclose(p2.theta, p.theta, atol=2e-5)
        np.testing.assert_allclose(p2.k, p.k, rtol=1e-4)
        np.testing.assert_allclose(p2.delta, p.delta, atol=1e-4)
        np.testing.assert_allclose(p2.t, p.t, atol=2e-2)
        np.testing.assert_allclose(p2.v, p.v, atol=1e-7)

    def test_roundtrip_matrix(self, rng):
        """H -> params -> H reproduces the (normalized) matrix."""
        p = random_params(rng, 64)
        h = compose_homography(p, CENTER)
        p2, _ = decompose_homography(h, CENTER)
        h2 = compose_homography(p2, CENTER)
        np.testing.assert_allclose(h2, h, atol=1e-2)  # absolute: t entries ~50

    def test_identity(self):
        p, valid = decompose_homography(jnp.eye(3), CENTER)
        assert bool(valid)
        np.testing.assert_allclose(p.scale, 1.0, atol=1e-6)
        np.testing.assert_allclose(p.theta, 0.0, atol=1e-6)
        np.testing.assert_allclose(p.t, 0.0, atol=1e-5)

    def test_pure_rotation_about_center(self):
        """A rotation about the center must yield t=0 (center re-anchoring)."""
        ang = 0.3
        c, s = np.cos(ang), np.sin(ang)
        cx, cy = float(CENTER[0]), float(CENTER[1])
        # rotation about (cx, cy) in pixel coords
        h = np.array(
            [
                [c, -s, cx - c * cx + s * cy],
                [s, c, cy - s * cx - c * cy],
                [0, 0, 1],
            ],
            np.float32,
        )
        p, valid = decompose_homography(jnp.asarray(h), CENTER)
        assert bool(valid)
        np.testing.assert_allclose(p.theta, ang, atol=1e-6)
        np.testing.assert_allclose(p.t, 0.0, atol=1e-3)
        np.testing.assert_allclose(p.scale, 1.0, atol=1e-6)

    def test_degenerate_h33(self):
        h = jnp.eye(3).at[2, 2].set(0.0)
        p, valid = decompose_homography(h, CENTER)
        assert not bool(valid)
        np.testing.assert_allclose(p.scale, 1.0)  # identity substituted

    def test_negative_det(self):
        h = jnp.diag(jnp.array([-1.0, 1.0, 1.0]))  # reflection: det(sRK) < 0
        _, valid = decompose_homography(h, CENTER)
        assert not bool(valid)

    def test_jit_and_vmap(self, rng):
        p = random_params(rng, 8)
        h = compose_homography(p, CENTER)
        f = jax.jit(lambda m: decompose_homography(m, CENTER))
        p2, valid = f(h)
        assert bool(jnp.all(valid))
        p3, _ = jax.vmap(lambda m: decompose_homography(m, CENTER))(h)
        np.testing.assert_allclose(p2.theta, p3.theta, atol=1e-7)


class TestRemoveScale:
    def test_scale_removed_rotation_kept(self, rng):
        p = random_params(rng, 32, perspective=False)
        # pure similarity: no shear/anisotropy
        p = p._replace(k=jnp.ones_like(p.k), delta=jnp.zeros_like(p.delta))
        h = compose_homography(p, CENTER)
        h_rigid, valid = remove_isotropic_scale(h, CENTER)
        assert bool(jnp.all(valid))
        p2, _ = decompose_homography(h_rigid, CENTER)
        np.testing.assert_allclose(p2.scale, 1.0, atol=1e-5)
        np.testing.assert_allclose(p2.theta, p.theta, atol=1e-5)
        np.testing.assert_allclose(p2.t, p.t, atol=5e-2)

    def test_invalid_becomes_identity(self):
        h = jnp.zeros((3, 3))
        h_out, valid = remove_isotropic_scale(h, CENTER)
        assert not bool(valid)
        np.testing.assert_allclose(h_out, np.eye(3))


def test_identity_homography_batched():
    h = identity_homography((4, 5))
    assert h.shape == (4, 5, 3, 3)
    np.testing.assert_allclose(h[2, 3], np.eye(3))
