"""SIFT tests: behavioral registration quality (like ORB's)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from video_stabilization.config import RansacConfig, SIFTConfig
from video_stabilization.motion import decompose_homography, estimate_similarity_ransac
from video_stabilization.ops.match import match_l2
from video_stabilization.ops.sift import sift_detect_and_compute
from video_stabilization.sim import (
    DEFAULT_APP_PARAMS,
    inter_frame_homography,
    make_default_texture,
    move_right,
    render_frame,
    roll_clockwise,
)

H, W = 360, 640
CFG = SIFTConfig(max_features=512)


def sim_gray(p):
    tex = make_default_texture(jax.random.key(0), size=512)
    f = np.asarray(render_frame(tex, p, H, W))
    return cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).astype(np.float32)


class TestSIFTDetect:
    def test_detects_enough(self):
        g = sim_gray(DEFAULT_APP_PARAMS)
        feats = sift_detect_and_compute(jnp.asarray(g), CFG)
        n = int(feats.mask.sum())
        assert n > 100
        d = np.asarray(feats.desc)[np.asarray(feats.mask)]
        norms = np.linalg.norm(d, axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-3)  # L2 normalized

    def test_flat_image_no_keypoints(self):
        flat = jnp.full((128, 128), 100.0)
        feats = sift_detect_and_compute(flat, CFG)
        assert int(feats.mask.sum()) == 0

    def test_jit_static_shapes(self):
        g = sim_gray(DEFAULT_APP_PARAMS)
        f = jax.jit(lambda x: sift_detect_and_compute(x, CFG))
        feats = f(jnp.asarray(g))
        assert feats.desc.shape[1] == 128


class TestSIFTRegistration:
    def test_recovers_motion(self):
        pa = DEFAULT_APP_PARAMS
        pb = roll_clockwise(move_right(pa, 0.15), 0.5)
        ga, gb = sim_gray(pa), sim_gray(pb)
        fa = sift_detect_and_compute(jnp.asarray(ga), CFG)
        fb = sift_detect_and_compute(jnp.asarray(gb), CFG)
        m = match_l2(fa.desc, fa.mask, fb.desc, fb.mask, avg_ratio=0.75)
        assert int(m.valid.sum()) > 25

        res = estimate_similarity_ransac(
            fa.points, fb.points[m.idx], m.valid, jax.random.key(0),
            RansacConfig(num_hypotheses=256, inlier_threshold=5.0),
        )
        assert bool(res.valid)
        h_true = np.asarray(inter_frame_homography(pa, pb, H, W))
        c = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], float).T
        pe = np.asarray(res.h, float) @ c
        pe /= pe[2]
        pt = h_true @ c
        pt /= pt[2]
        assert np.abs(pe[:2] - pt[:2]).mean() < 2.5

    def test_rotation_invariance(self):
        pa = DEFAULT_APP_PARAMS
        pb = pa._replace(roll=pa.roll + 20.0)
        ga, gb = sim_gray(pa), sim_gray(pb)
        fa = sift_detect_and_compute(jnp.asarray(ga), CFG)
        fb = sift_detect_and_compute(jnp.asarray(gb), CFG)
        m = match_l2(fa.desc, fa.mask, fb.desc, fb.mask, avg_ratio=0.75)
        res = estimate_similarity_ransac(
            fa.points, fb.points[m.idx], m.valid, jax.random.key(1),
            RansacConfig(num_hypotheses=256, inlier_threshold=5.0),
        )
        assert bool(res.valid)
        params, ok = decompose_homography(res.h, jnp.array([W / 2, H / 2]))
        assert bool(ok)
        np.testing.assert_allclose(np.rad2deg(float(params.theta)), 20.0, atol=2.0)
