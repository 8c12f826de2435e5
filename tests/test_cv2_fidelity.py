"""Element-exactness of the reference-compat fidelity stages vs installed cv2.

These are the stages that close the drift-vs-reference gate (BENCH config 1,
``drift_vs_reference_px``): exact u8 gray, element-exact GFTT corner lists
(ops/gftt_host.py), and the cv2-faithful LK border behavior.  Together with
the bit-exact RANSAC replica (tests/test_cv2_ransac.py) they brought the
measured drift from 0.51 px (round 3) to ~3e-5 px.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from video_stabilization.ops.gftt_host import (  # noqa: E402
    good_features_to_track_np,
    gray_u8_cv2exact_np,
    min_eig_response_np,
)


def _rand_img(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


@pytest.mark.parametrize("shape", [(1080, 1920, 360, 640),
                                   (720, 1280, 360, 640),
                                   (360, 640, 360, 640)])
def test_gray_np_bit_exact(shape):
    h, w, oh, ow = shape
    rng = np.random.default_rng(h)
    img = _rand_img(rng, h, w)
    g_cv = cv2.cvtColor(cv2.resize(img, (ow, oh),
                                   interpolation=cv2.INTER_LINEAR),
                        cv2.COLOR_BGR2GRAY)
    g_my = gray_u8_cv2exact_np(img, oh, ow)
    np.testing.assert_array_equal(g_cv, g_my)


def test_gray_jax_matches_np():
    import jax.numpy as jnp

    from video_stabilization.ops.image import gray_u8_cv2exact

    rng = np.random.default_rng(0)
    img = _rand_img(rng, 720, 1280)
    g_np = gray_u8_cv2exact_np(img, 360, 640)
    g_jx = np.asarray(gray_u8_cv2exact(jnp.asarray(img), 360, 640))
    np.testing.assert_array_equal(g_np, g_jx.astype(np.uint8))


def test_min_eig_response_element_exact():
    rng = np.random.default_rng(1)
    g = rng.integers(0, 256, (360, 640), np.uint8)
    target = cv2.cornerMinEigenVal(g, 3, 3)
    mine = min_eig_response_np(g)
    # the dy Sobel row stage is replicated to ~1-ULP on a few % of pixels
    # (its exact SIMD grouping is unidentified); everything else — dx, the
    # f64 box accumulation, the eigenvalue formula — is bitwise.  Pure-noise
    # images exercise the dy ULP path hardest (~94% bitwise, ≤ 2 ULP
    # elsewhere); on natural/rendered frames the map measures fully bitwise.
    eq = mine == target
    assert eq.mean() > 0.9
    rel = np.abs(mine - target) / np.maximum(np.abs(target), 1e-12)
    assert rel.max() < 1e-5

    smooth = cv2.GaussianBlur(g, (5, 5), 1.2)
    t2 = cv2.cornerMinEigenVal(smooth, 3, 3)
    m2 = min_eig_response_np(smooth)
    assert (m2 == t2).mean() > 0.99


def test_gftt_list_equal_random():
    rng = np.random.default_rng(2)
    g = rng.integers(0, 256, (360, 640), np.uint8)
    pts_cv = cv2.goodFeaturesToTrack(g, maxCorners=500, qualityLevel=0.01,
                                     minDistance=5.0, blockSize=3)
    pts_my = good_features_to_track_np(g, 500, 0.01, 5.0)
    pts_cv = pts_cv.reshape(-1, 2)
    assert len(pts_cv) == len(pts_my)
    np.testing.assert_array_equal(pts_cv, pts_my)


def test_gftt_list_equal_with_exact_ties():
    # tile one patch so distant pixels have IDENTICAL responses: exercises
    # cv2's pointer tie-break (greaterThanPtr orders equal responses by
    # DESCENDING scan index), which scan-order-stable sorting gets wrong
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, (90, 160), np.uint8)
    g = np.tile(tile, (4, 4))                          # 360 x 640
    pts_cv = cv2.goodFeaturesToTrack(g, maxCorners=1300, qualityLevel=0.01,
                                     minDistance=5.0, blockSize=3)
    pts_my = good_features_to_track_np(g, 1300, 0.01, 5.0)
    pts_cv = pts_cv.reshape(-1, 2)
    assert len(pts_cv) == len(pts_my)
    np.testing.assert_array_equal(pts_cv, pts_my)


def test_lk_cv2exact_border_points():
    # cv2's LK reads REFLECT_101 image padding but ZERO-padded derivatives
    # outside the frame; border points previously disagreed by ~1 px (the
    # dominant drift tail).  Track a known shift with points close to every
    # border and require sub-2e-2 px worst-case endpoint agreement with cv2.
    import jax.numpy as jnp

    from video_stabilization.config import LKConfig
    from video_stabilization.ops.lk import lk_track
    from video_stabilization.ops.pyramid import build_pyramid

    rng = np.random.default_rng(4)
    big = rng.integers(0, 256, (140, 180), np.uint8)
    a = big[4:124, 6:166]                                  # 120 x 160
    b = big[2:122, 5:165]                                  # shift (+1, +2)

    pts = []
    for y in [1.0, 2.0, 3.0, 60.0, 116.0, 118.0]:
        for x in [1.0, 2.0, 80.0, 157.0, 158.0]:
            pts.append((x, y))
    pts = np.array(pts, np.float32)

    nxt, st, _ = cv2.calcOpticalFlowPyrLK(
        a, b, pts.reshape(-1, 1, 2), None, winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 0.01),
        minEigThreshold=1e-4)
    st = st.reshape(-1).astype(bool)

    cfg = LKConfig(method="cv2exact")
    pyr_a = build_pyramid(jnp.asarray(a, jnp.float32), cfg.pyramid_levels)
    pyr_b = build_pyramid(jnp.asarray(b, jnp.float32), cfg.pyramid_levels)
    res = lk_track(pyr_a, pyr_b, jnp.asarray(pts),
                   jnp.ones(len(pts), bool), cfg)
    my_pts = np.asarray(res.points)
    my_st = np.asarray(res.status)

    common = st & my_st
    assert common.sum() >= 0.8 * len(pts)
    d = np.linalg.norm(nxt.reshape(-1, 2)[common] - my_pts[common], axis=1)
    assert d.max() < 2e-2, f"worst endpoint diff {d.max():.4f} px"
