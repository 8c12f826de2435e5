"""Fidelity tests for image ops against OpenCV (the reference's L1)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from video_stabilization.ops import (
    bgr_to_gray,
    build_pyramid,
    pyr_down,
    resize_bilinear,
    resize_nearest,
    warp_perspective,
)


def rand_img(rng, h=72, w=96, c=None):
    shape = (h, w) if c is None else (h, w, c)
    return (rng.uniform(0, 255, shape)).astype(np.float32)


class TestColor:
    def test_gray_matches_cv2(self, rng):
        img = rng.integers(0, 256, (64, 80, 3), np.uint8)
        ours = np.asarray(bgr_to_gray(jnp.asarray(img)))
        ref = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.float32)
        assert np.abs(ours - ref).max() <= 1.0  # cv2 rounds fixed-point


class TestResize:
    def test_bilinear_matches_cv2(self, rng):
        img = rand_img(rng, 144, 256)
        ours = np.asarray(resize_bilinear(jnp.asarray(img), 72, 128))
        ref = cv2.resize(img, (128, 72), interpolation=cv2.INTER_LINEAR)
        assert np.abs(ours - ref).max() < 0.6

    def test_bilinear_upscale(self, rng):
        img = rand_img(rng, 36, 64)
        ours = np.asarray(resize_bilinear(jnp.asarray(img), 72, 128))
        ref = cv2.resize(img, (128, 72), interpolation=cv2.INTER_LINEAR)
        assert np.abs(ours - ref).max() < 0.6

    def test_bilinear_color(self, rng):
        img = rand_img(rng, 90, 160, 3)
        ours = np.asarray(resize_bilinear(jnp.asarray(img), 45, 80))
        ref = cv2.resize(img, (80, 45), interpolation=cv2.INTER_LINEAR)
        assert np.abs(ours - ref).max() < 0.6

    def test_nearest_matches_cv2(self, rng):
        img = rand_img(rng, 100, 140)
        ours = np.asarray(resize_nearest(jnp.asarray(img), 50, 70))
        ref = cv2.resize(img, (70, 50), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(ours, ref)

    def test_identity_resize(self, rng):
        img = rand_img(rng, 50, 60)
        np.testing.assert_allclose(
            np.asarray(resize_bilinear(jnp.asarray(img), 50, 60)), img, atol=1e-4
        )


class TestWarp:
    def test_identity_warp(self, rng):
        img = rand_img(rng)
        out = np.asarray(warp_perspective(jnp.asarray(img), jnp.eye(3)))
        np.testing.assert_allclose(out, img, atol=1e-3)

    def test_matches_cv2_rigid(self, rng):
        img = rand_img(rng, 120, 160)
        ang = 0.1
        c, s = np.cos(ang), np.sin(ang)
        h = np.array([[c, -s, 9.3], [s, c, -4.7], [0, 0, 1]], np.float32)
        ours = np.asarray(warp_perspective(jnp.asarray(img), jnp.asarray(h)))
        ref = cv2.warpPerspective(
            img, h.astype(np.float64), (160, 120), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0.0,
        )
        # Compare where both consider the sample in-bounds (border handling
        # at the exact edge differs by <=1px ring).
        inner = np.abs(ours - ref) * (ref != 0) * (ours != 0)
        assert np.median(np.abs(ours - ref)) < 0.5
        assert (np.abs(ours - ref) < 1.0).mean() > 0.97

    def test_matches_cv2_projective(self, rng):
        img = rand_img(rng, 120, 160)
        h = np.array(
            [[1.02, 0.01, -3.0], [-0.015, 0.99, 2.0], [1e-5, -2e-5, 1.0]],
            np.float32,
        )
        ours = np.asarray(warp_perspective(jnp.asarray(img), jnp.asarray(h)))
        ref = cv2.warpPerspective(img, h.astype(np.float64), (160, 120))
        assert (np.abs(ours - ref) < 1.0).mean() > 0.97

    def test_border_value(self, rng):
        img = rand_img(rng, 50, 50)
        h = np.array([[1, 0, 100.0], [0, 1, 0], [0, 0, 1]], np.float32)  # shift out
        out = np.asarray(warp_perspective(jnp.asarray(img), jnp.asarray(h),
                                          border_value=7.5))
        assert np.all(out[:, :90] == 7.5)

    def test_color_warp(self, rng):
        img = rand_img(rng, 60, 80, 3)
        h = np.array([[1, 0, 5.0], [0, 1, 3.0], [0, 0, 1]], np.float32)
        ours = np.asarray(warp_perspective(jnp.asarray(img), jnp.asarray(h)))
        ref = cv2.warpPerspective(img, h.astype(np.float64), (80, 60))
        assert (np.abs(ours - ref) < 1.0).mean() > 0.95

    def test_jit(self, rng):
        img = rand_img(rng)
        f = jax.jit(warp_perspective)
        out = f(jnp.asarray(img), jnp.eye(3))
        np.testing.assert_allclose(np.asarray(out), img, atol=1e-3)


class TestPyramid:
    def test_pyrdown_matches_cv2(self, rng):
        img = rand_img(rng, 128, 192)
        ours = np.asarray(pyr_down(jnp.asarray(img)))
        ref = cv2.pyrDown(img)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=0.5)

    def test_pyrdown_odd_size(self, rng):
        img = rand_img(rng, 45, 61)
        ours = np.asarray(pyr_down(jnp.asarray(img)))
        # cv2.pyrDown outputs ceil(n/2); ours keeps even indices = ceil(n/2)
        assert ours.shape == (23, 31)

    def test_build_pyramid_shapes(self, rng):
        img = rand_img(rng, 360, 640)
        pyr = build_pyramid(jnp.asarray(img), 3)
        assert len(pyr) == 4
        assert pyr[0].shape == (360, 640)
        assert pyr[1].shape == (180, 320)
        assert pyr[2].shape == (90, 160)
        assert pyr[3].shape == (45, 80)


class TestWarpAffineVsCv2:
    """The affine output warp must match cv2.warpPerspective on affine
    transforms (interior pixels; cv2's fixed-point bilinear weights differ
    from float weights by a fraction of a gray level)."""

    def _check(self, img, h, tol_frac=0.9, tol=3.0):
        import cv2 as _cv2
        from video_stabilization.ops.warp import warp_affine

        ours = np.asarray(warp_affine(jnp.asarray(img), jnp.asarray(h)))
        ref = _cv2.warpPerspective(
            img, h.astype(np.float64), (img.shape[1], img.shape[0]),
            flags=_cv2.INTER_LINEAR,
        )
        sel = (ref > 1e-3) & (ours > 1e-3)  # interior (both non-border)
        diff = np.abs(ours - ref)[sel]
        assert (diff < tol).mean() > tol_frac, (
            f"frac within {tol}: {(diff < tol).mean():.3f}"
        )

    def test_sampling_map_exact(self, rng):
        """The decisive property: warping coordinate-ramp images measures the
        effective sampling map, which must equal the analytic inverse map."""
        from video_stabilization.ops.warp import warp_affine

        H2, W2 = 120, 160
        xr = np.tile(np.arange(W2, dtype=np.float32), (H2, 1))
        yr = np.tile(np.arange(H2, dtype=np.float32)[:, None], (1, W2))
        ang = np.deg2rad(3.0)
        c, s = np.cos(ang), np.sin(ang)
        h = np.array([[1.004 * c, -1.004 * s, 9.3],
                      [1.004 * s, 1.004 * c, -4.7], [0, 0, 1]], np.float32)
        hinv = np.linalg.inv(h.astype(np.float64))
        ys, xs = np.mgrid[0:H2, 0:W2].astype(np.float64)
        sx = hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]
        sy = hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]
        ox = np.asarray(warp_affine(jnp.asarray(xr), jnp.asarray(h), border_value=-1))
        oy = np.asarray(warp_affine(jnp.asarray(yr), jnp.asarray(h), border_value=-1))
        sel = (ox >= 0) & (oy >= 0) & (sx > 1) & (sx < W2 - 2) & (sy > 1) & (sy < H2 - 2)
        assert np.abs((ox - sx)[sel]).max() < 2e-2
        assert np.abs((oy - sy)[sel]).max() < 2e-2

    def test_rigid(self, rng):
        img = cv2.GaussianBlur(rand_img(rng, 120, 160), (5, 5), 1.0)
        ang = np.deg2rad(3.0)
        c, s = np.cos(ang), np.sin(ang)
        h = np.array([[c, -s, 9.3], [s, c, -4.7], [0, 0, 1]], np.float32)
        self._check(img, h)

    def test_translation_only(self, rng):
        img = rand_img(rng, 100, 140)
        h = np.array([[1, 0, 17.25], [0, 1, -6.5], [0, 0, 1]], np.float32)
        self._check(img, h, tol=1.0)

    def test_scaled_affine(self, rng):
        img = cv2.GaussianBlur(rand_img(rng, 120, 160), (9, 9), 2.5)
        h = np.array(
            [[1.01 * np.cos(0.03), -1.01 * np.sin(0.03), 4.0],
             [1.01 * np.sin(0.03), 1.01 * np.cos(0.03), 2.0],
             [0, 0, 1]], np.float32,
        )
        self._check(img, h, tol_frac=0.85)

    def test_identity(self, rng):
        from video_stabilization.ops.warp import warp_affine

        img = rand_img(rng, 80, 100)
        out = np.asarray(warp_affine(jnp.asarray(img), jnp.eye(3)))
        np.testing.assert_allclose(out, img, atol=1e-3)

    def test_color(self, rng):
        from video_stabilization.ops.warp import warp_affine

        img = rand_img(rng, 60, 80, 3)
        h = np.array([[1, 0, 5.0], [0, 1, 3.0], [0, 0, 1]], np.float32)
        ours = np.asarray(warp_affine(jnp.asarray(img), jnp.asarray(h)))
        ref = cv2.warpPerspective(img, h.astype(np.float64), (80, 60))
        sel = ref > 1e-3
        assert (np.abs(ours - ref)[sel] < 1.0).mean() > 0.95

    def test_border_fill(self, rng):
        from video_stabilization.ops.warp import warp_affine

        img = rand_img(rng, 50, 50)
        h = np.array([[1, 0, 100.0], [0, 1, 0], [0, 0, 1]], np.float32)
        out = np.asarray(warp_affine(jnp.asarray(img), jnp.asarray(h),
                                           border_value=7.5))
        assert np.all(out[:, :90] == 7.5)


class TestExtractPatchesMXU:
    def test_matches_direct_indexing(self):
        """One-hot MXU extraction must equal direct (bf16) indexing on both
        contraction orders (landscape picks column-first, portrait
        row-first)."""
        from video_stabilization.ops.patches import extract_patches_mxu

        rng = np.random.default_rng(3)
        for h, w in ((40, 64), (64, 40)):
            planes = jnp.asarray(
                rng.uniform(0, 255, (2, h, w)).astype(np.float32))
            n, p = 7, 9
            iy = jnp.asarray(rng.integers(0, h - p, n).astype(np.int32))
            ix = jnp.asarray(rng.integers(0, w - p, n).astype(np.int32))
            got = np.asarray(extract_patches_mxu(planes, iy, ix, p))
            ref16 = np.asarray(planes.astype(jnp.bfloat16)).astype(np.float32)
            for i in range(n):
                want = ref16[:, int(iy[i]):int(iy[i]) + p,
                             int(ix[i]):int(ix[i]) + p]
                np.testing.assert_array_equal(got[i], want)
