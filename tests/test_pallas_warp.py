"""Affine output warp (ops/warp.py ``warp_affine``): geometric exactness,
parity with the projective warp and a float64 reference, borders, large
rotations, and stream batching (vmap)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from video_stabilization.ops.reference import warp_bilinear_reference
from video_stabilization.ops.warp import warp_affine, warp_perspective


def rigid(theta_deg, tx=0.0, ty=0.0, s=1.0):
    t = np.deg2rad(theta_deg)
    m = np.eye(3)
    m[:2, :2] = s * np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    m[0, 2], m[1, 2] = tx, ty
    return jnp.asarray(m, jnp.float32)


H, W = 72, 150


def ramps():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return yy, xx


class TestGeometry:
    @pytest.mark.parametrize("theta,tx,ty", [
        (0.0, 0.0, 0.0), (0.0, 7.3, -4.2), (2.0, 3.3, -2.7),
        (8.0, 0.0, 0.0), (-5.0, -10.0, 6.0),
    ])
    def test_coordinate_ramps_exact(self, theta, tx, ty):
        """Warping linear coordinate ramps must reproduce the analytic
        inverse map — interpolation-kernel differences vanish on linear
        images, so this isolates pure geometry."""
        yy, xx = ramps()
        h = rigid(theta, tx, ty)
        hi = np.linalg.inv(np.asarray(h))
        sx = hi[0, 0] * xx + hi[0, 1] * yy + hi[0, 2]
        sy = hi[1, 0] * xx + hi[1, 1] * yy + hi[1, 2]
        sel = (sx >= 1) & (sx <= W - 2) & (sy >= 1) & (sy <= H - 2)
        ox = np.asarray(warp_affine(jnp.asarray(xx), h, -1.0))
        oy = np.asarray(warp_affine(jnp.asarray(yy), h, -1.0))
        assert np.abs((ox - sx)[sel]).max() < 2e-2
        assert np.abs((oy - sy)[sel]).max() < 2e-2

    def test_identity_is_exact(self):
        img = jnp.asarray(
            np.random.default_rng(0).uniform(0, 255, (H, W, 3)).astype(np.float32)
        )
        out = np.asarray(warp_affine(img, jnp.eye(3), 0.0))
        np.testing.assert_allclose(out, np.asarray(img), atol=1e-3)

    def test_integer_translation_is_exact(self):
        img = jnp.asarray(
            np.random.default_rng(1).uniform(0, 255, (H, W)).astype(np.float32)
        )
        out = np.asarray(warp_affine(img, rigid(0, 5, -3), -1.0))
        ref = np.asarray(img)
        np.testing.assert_allclose(out[:-3, 5:], ref[3:, : W - 5], atol=1e-2)


class TestParity:
    def test_matches_gather_warp_on_natural_content(self):
        """Value parity with warp_perspective and with the float64 bilinear
        reference on smooth content."""
        yy, xx = ramps()
        img_np = (np.sin(xx / 7) * np.cos(yy / 9) * 80 + 120).astype(np.float32)
        img = jnp.asarray(img_np)
        for theta in (1.0, 4.0, -3.0):
            h = rigid(theta, 2.5, -1.5)
            a = np.asarray(warp_affine(img, h, 0.0))
            b = np.asarray(warp_perspective(img, h, None, 0.0))
            ref = warp_bilinear_reference(img_np, np.asarray(h), 0.0)
            assert np.abs(a - b).max() < 1e-3
            # pixels exactly on the source edge may fall either side of the
            # in-bounds test in float32 vs float64
            assert (np.abs(a - ref) < 0.05).mean() > 0.995

    def test_border_fill(self):
        img = jnp.full((H, W, 3), 100.0)
        out = np.asarray(warp_affine(img, rigid(0, 40, 0), jnp.array([1.0, 2.0, 3.0])))
        np.testing.assert_allclose(
            out[:, :39], np.broadcast_to([1.0, 2.0, 3.0], out[:, :39].shape), atol=1e-4
        )
        np.testing.assert_allclose(
            out[:, 41:], np.full_like(out[:, 41:], 100.0), atol=1e-3
        )

    def test_large_rotation_equals_warp_perspective(self):
        """A gather warp has no rotation envelope: 30 degrees renders the
        same as the projective warp."""
        img = jnp.asarray(
            np.random.default_rng(2).uniform(0, 255, (H, W)).astype(np.float32)
        )
        h = rigid(30.0, 4.0, -2.0)
        a = np.asarray(warp_affine(img, h, 0.0))
        b = np.asarray(warp_perspective(img, h, None, 0.0))
        np.testing.assert_allclose(a, b, atol=1e-3)


class TestBatched:
    def test_vmap_matches_per_stream(self):
        rng = np.random.default_rng(3)
        imgs = jnp.asarray(rng.uniform(0, 255, (3, H, W, 3)).astype(np.float32))
        hs = jnp.stack([rigid(1.0, 2, 1), rigid(-2.0, -3, 0), rigid(0.0, 5, 5)])
        f = jax.vmap(lambda im, hh: warp_affine(im, hh, 0.0))
        out = np.asarray(f(imgs, hs))
        for i in range(3):
            ref = np.asarray(warp_affine(imgs[i], hs[i], 0.0))
            np.testing.assert_allclose(out[i], ref, atol=1e-3)
