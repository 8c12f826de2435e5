"""ORB + matching tests: behavioral (registration quality), not bitwise.

Our BRIEF pattern differs from OpenCV's learned pattern by design (see
ops/orb.py), so fidelity is judged where it matters: matched
correspondences must recover known simulator motion.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from video_stabilization.config import ORBConfig, RansacConfig
from video_stabilization.motion import estimate_similarity_ransac
from video_stabilization.ops.fast import fast_score
from video_stabilization.ops.match import match_hamming_knn, match_l2
from video_stabilization.ops.reference import fast_score_reference
from video_stabilization.ops.orb import orb_detect_and_compute
from video_stabilization.sim import (
    DEFAULT_APP_PARAMS,
    inter_frame_homography,
    make_default_texture,
    move_right,
    render_frame,
    roll_clockwise,
)

H, W = 360, 640
CFG = ORBConfig(max_features=512, n_levels=6)


def sim_gray(p):
    tex = make_default_texture(jax.random.key(0), size=512)
    f = np.asarray(render_frame(tex, p, H, W))
    return cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).astype(np.float32)


class TestFAST:
    def test_agrees_with_cv2_fast(self):
        g = sim_gray(DEFAULT_APP_PARAMS)
        score, corners = fast_score(jnp.asarray(g), 20.0)
        ours = np.argwhere(np.asarray(corners))

        fast = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=False)
        kps = fast.detect(g.astype(np.uint8), None)
        ref = np.array([[kp.pt[1], kp.pt[0]] for kp in kps])
        assert len(ours) > 100 and len(ref) > 100

        from scipy.spatial import cKDTree
        d, _ = cKDTree(ours).query(ref)
        assert np.median(d) <= 1.0       # cv2 corners are (nearly all) ours too

    def test_flat_image_no_corners(self):
        flat = jnp.full((64, 64), 100.0)
        _, corners = fast_score(flat, 20.0)
        assert not bool(jnp.any(corners))

    def test_matches_bruteforce_segment_test(self):
        """fast_score must equal the brute-force numpy segment test exactly,
        including on shapes with odd and small sizes."""
        rng = np.random.default_rng(7)
        for shape in ((64, 80), (360, 640), (47, 133)):
            img = rng.integers(0, 255, shape).astype(np.float32)
            s, c = fast_score(jnp.asarray(img), 20.0)
            ref = fast_score_reference(img, 20.0)
            np.testing.assert_array_equal(np.asarray(s), ref)
            np.testing.assert_array_equal(np.asarray(c), ref > 0)

    def test_matches_bruteforce_on_pyramid_shapes(self):
        """Every level shape of the production 360p ORB pyramid must match
        the brute-force segment test exactly."""
        rng = np.random.default_rng(9)
        h0, w0 = 360, 640
        for level in range(12):
            s = 1.2 ** level
            lh, lw = int(round(h0 / s)), int(round(w0 / s))
            if lh <= 62 or lw <= 62:
                break
            img = rng.integers(0, 255, (lh, lw)).astype(np.float32)
            got, _ = fast_score(jnp.asarray(img), 20.0)
            np.testing.assert_array_equal(
                np.asarray(got), fast_score_reference(img, 20.0),
                err_msg=f"level {level} shape ({lh}, {lw})")

    def test_matches_bruteforce_batched(self):
        """vmap over fast_score (the offline pipeline maps ORB detection over
        chunk frames) must match the per-image brute-force test."""
        rng = np.random.default_rng(8)
        imgs = rng.integers(0, 255, (3, 72, 96)).astype(np.float32)
        got, _ = jax.vmap(lambda im: fast_score(im, 20.0))(jnp.asarray(imgs))
        for i in range(3):
            np.testing.assert_array_equal(
                np.asarray(got[i]), fast_score_reference(imgs[i], 20.0))


class TestORB:
    def test_detects_enough(self):
        g = sim_gray(DEFAULT_APP_PARAMS)
        feats = orb_detect_and_compute(jnp.asarray(g), CFG)
        n = int(feats.mask.sum())
        assert n > 150
        assert feats.desc.shape[1] == 256
        # valid lanes have ±1 bits
        d = np.asarray(feats.desc)[np.asarray(feats.mask)]
        assert set(np.unique(d)) <= {-1, 1}

    def test_registration_recovers_motion(self):
        pa = DEFAULT_APP_PARAMS
        pb = roll_clockwise(move_right(pa, 0.15), 0.5)  # ~21px + 1 deg
        ga, gb = sim_gray(pa), sim_gray(pb)
        fa = orb_detect_and_compute(jnp.asarray(ga), CFG)
        fb = orb_detect_and_compute(jnp.asarray(gb), CFG)
        m = match_hamming_knn(fa.desc, fa.mask, fb.desc, fb.mask, 0.8)
        assert int(m.valid.sum()) > 40

        src = fa.points
        dst = fb.points[m.idx]
        res = estimate_similarity_ransac(
            src, dst, m.valid, jax.random.key(0),
            RansacConfig(num_hypotheses=256, inlier_threshold=5.0),
        )
        assert bool(res.valid)
        h_true = np.asarray(inter_frame_homography(pa, pb, H, W))
        c = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], float).T
        pe = np.asarray(res.h, float) @ c
        pe /= pe[2]
        pt = h_true @ c
        pt /= pt[2]
        drift = np.abs(pe[:2] - pt[:2]).mean()
        assert drift < 2.0  # px

    def test_rotation_invariance(self):
        """Steered BRIEF: a 25-degree in-plane rotation must still match."""
        pa = DEFAULT_APP_PARAMS
        pb = pa._replace(roll=pa.roll + 25.0)
        ga, gb = sim_gray(pa), sim_gray(pb)
        fa = orb_detect_and_compute(jnp.asarray(ga), CFG)
        fb = orb_detect_and_compute(jnp.asarray(gb), CFG)
        m = match_hamming_knn(fa.desc, fa.mask, fb.desc, fb.mask, 0.8)
        src = fa.points
        dst = fb.points[m.idx]
        res = estimate_similarity_ransac(
            src, dst, m.valid, jax.random.key(1),
            RansacConfig(num_hypotheses=256, inlier_threshold=5.0),
        )
        assert bool(res.valid)
        from video_stabilization.motion import decompose_homography
        params, ok = decompose_homography(res.h, jnp.array([W / 2, H / 2]))
        assert bool(ok)
        np.testing.assert_allclose(np.rad2deg(float(params.theta)), 25.0, atol=1.5)


class TestMatching:
    def test_hamming_identity(self, rng):
        d = jnp.asarray(rng.choice([-1, 1], (64, 256)), jnp.int8)
        mask = jnp.ones(64, bool)
        m = match_hamming_knn(d, mask, d, mask, lowe_ratio=0.99)
        np.testing.assert_array_equal(np.asarray(m.idx), np.arange(64))
        np.testing.assert_allclose(np.asarray(m.distance), 0.0)

    def test_hamming_masked_excluded(self, rng):
        d1 = jnp.asarray(rng.choice([-1, 1], (8, 256)), jnp.int8)
        d2 = jnp.concatenate([d1, d1], axis=0)
        mask2 = jnp.asarray([False] * 8 + [True] * 8)
        m = match_hamming_knn(d1, jnp.ones(8, bool), d2, mask2, 0.99)
        assert np.all(np.asarray(m.idx) >= 8)  # masked copies never matched

    def test_l2_threshold_filter(self, rng):
        d1 = jnp.asarray(rng.normal(size=(32, 128)), jnp.float32)
        noise = jnp.asarray(rng.normal(size=(32, 128)) * 0.01, jnp.float32)
        d2 = d1 + noise
        m = match_l2(d1, jnp.ones(32, bool), d2, jnp.ones(32, bool))
        np.testing.assert_array_equal(np.asarray(m.idx), np.arange(32))


class TestFactoredRotation:
    def test_factored_rotation_exact(self):
        """The rot90-factored descriptor sampler must reproduce the direct
        72-bin steered lookup bit-for-bit (ops/orb.py _orient_and_describe;
        near-tie bits within bf16 rounding of the patch values excluded)."""
        from video_stabilization.ops.orb import (
            _EXTRACT, _EXTRACT_RADIUS, _gauss7, _orient_and_describe,
            CENTROID_X, CENTROID_Y, N_ANGLE_BINS, PATCH_RADIUS,
            STEERED_LIN_1, STEERED_LIN_2,
        )

        rng = np.random.default_rng(11)
        img = rng.uniform(0, 255, (160, 200)).astype(np.float32)
        # smooth a little so orientations are well-defined
        import scipy.ndimage as ndi

        img = ndi.gaussian_filter(img, 1.2)
        blur = np.asarray(_gauss7(jnp.asarray(img)))
        pts = np.array(
            [[60.0, 60.0], [100.0, 80.0], [140.0, 50.0], [80.0, 100.0],
             [120.0, 90.0], [66.0, 77.0]], np.float32
        )
        mask = np.ones(len(pts), bool)
        ang, desc = _orient_and_describe(
            jnp.asarray(img), jnp.asarray(blur), jnp.asarray(pts),
            jnp.asarray(mask), pattern="brief",
        )
        desc = np.asarray(desc)

        rad = _EXTRACT_RADIUS
        checked = 0
        for i, (x, y) in enumerate(pts):
            iy = int(np.clip(round(y) - rad, 0, img.shape[0] - _EXTRACT))
            ix = int(np.clip(round(x) - rad, 0, img.shape[1] - _EXTRACT))
            praw = img[iy : iy + _EXTRACT, ix : ix + _EXTRACT]
            pblur = blur[iy : iy + _EXTRACT, ix : ix + _EXTRACT].ravel()
            off = rad - PATCH_RADIUS
            raw31 = praw[off : off + 31, off : off + 31]
            m10 = float((raw31 * CENTROID_X).sum())
            m01 = float((raw31 * CENTROID_Y).sum())
            b = int(np.round(np.arctan2(m01, m10) * (N_ANGLE_BINS / (2 * np.pi)))) % N_ANGLE_BINS
            v0 = pblur[STEERED_LIN_1[b]]
            v1 = pblur[STEERED_LIN_2[b]]
            want = np.where(v0 < v1, 1, -1).astype(np.int8)
            clear = np.abs(v0 - v1) > 1.0       # exclude bf16 near-ties
            got = desc[i]
            assert (got[clear] == want[clear]).all(), (
                i, b, (got[clear] != want[clear]).sum()
            )
            checked += clear.sum()
        assert checked > 1000
