"""GFTT + pyramidal LK fidelity tests against OpenCV on simulator frames.

The comparison is statistical, not index-by-index (SURVEY.md §7 "Hard parts"):
GFTT is compared as corner-set coverage, LK as endpoint agreement on the same
input corners.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from video_stabilization.config import GFTTConfig, LKConfig
from video_stabilization.ops import build_pyramid
from video_stabilization.ops.gftt import good_features_to_track, min_eig_response
from video_stabilization.ops.lk import lk_track
from video_stabilization.sim import (
    DEFAULT_APP_PARAMS,
    make_default_texture,
    move_right,
    render_frame,
    roll_clockwise,
)

H, W = 360, 640


def sim_pair():
    tex = make_default_texture(jax.random.key(0), size=512)
    pa = DEFAULT_APP_PARAMS
    pb = roll_clockwise(move_right(pa, 0.3), 0.25)  # ~3.2px shift + 0.5 deg
    fa = np.asarray(render_frame(tex, pa, H, W))
    fb = np.asarray(render_frame(tex, pb, H, W))
    ga = cv2.cvtColor(fa, cv2.COLOR_BGR2GRAY)
    gb = cv2.cvtColor(fb, cv2.COLOR_BGR2GRAY)
    return ga, gb


class TestMinEigResponse:
    def test_rank_correlates_with_cv2(self):
        ga, _ = sim_pair()
        ours = np.asarray(min_eig_response(jnp.asarray(ga, jnp.float32)))
        ref = cv2.cornerMinEigenVal(ga, blockSize=3, ksize=3)
        # identical up to a global positive scale -> near-perfect correlation
        inner = (slice(8, -8), slice(8, -8))
        corr = np.corrcoef(ours[inner].ravel(), ref[inner].ravel())[0, 1]
        assert corr > 0.99


class TestGFTT:
    def test_covers_cv2_corners(self):
        ga, _ = sim_pair()
        cfg = GFTTConfig(max_features=1280)
        ours = good_features_to_track(jnp.asarray(ga, jnp.float32), cfg)
        pts = np.asarray(ours.points)[np.asarray(ours.mask)]
        assert len(pts) > 300

        ref = cv2.goodFeaturesToTrack(
            ga, maxCorners=1300, qualityLevel=0.01, minDistance=5,
            mask=None, blockSize=3,
        ).reshape(-1, 2)
        # every strong cv2 corner should have one of ours nearby (<= cell diag)
        from scipy.spatial import cKDTree

        tree = cKDTree(pts)
        d, _ = tree.query(ref[:200])  # 200 strongest cv2 corners
        assert np.median(d) < 4.0
        assert (d < 8.0).mean() > 0.9

    def test_min_spacing_within_cells(self):
        ga, _ = sim_pair()
        ours = good_features_to_track(jnp.asarray(ga, jnp.float32))
        pts = np.asarray(ours.points)[np.asarray(ours.mask)]
        # cell-based suppression: no two corners share a cell => count bounded
        # by number of cells, and average nearest-neighbor spacing >= ~cell/2
        from scipy.spatial import cKDTree

        d, _ = cKDTree(pts).query(pts, k=2)
        assert np.median(d[:, 1]) >= 2.5  # cell=5 at 360p

    def test_jit_static_shapes(self):
        ga, _ = sim_pair()
        f = jax.jit(lambda x: good_features_to_track(x, GFTTConfig(max_features=512)))
        out = f(jnp.asarray(ga, jnp.float32))
        assert out.points.shape == (512, 2)
        assert out.mask.shape == (512,)


class TestLK:
    def test_accuracy_vs_ground_truth(self):
        """Score against the ANALYTIC motion (the referee cv2 never had).

        The SSD-sweep redesign finds global minima where cv2's local Newton
        iterations can lock onto aliased ones, so endpoints are compared to
        the simulator's exact homography; the tracker must be at least as
        accurate as cv2 on the same corners (non-inferiority), and strongly
        accurate in absolute terms.
        """
        from video_stabilization.motion.similarity import transform_points
        from video_stabilization.sim import inter_frame_homography

        tex = make_default_texture(jax.random.key(0), size=512)
        pa = DEFAULT_APP_PARAMS
        pb = roll_clockwise(move_right(pa, 0.3), 0.25)
        fa = np.asarray(render_frame(tex, pa, H, W))
        fb = np.asarray(render_frame(tex, pb, H, W))
        ga = cv2.cvtColor(fa, cv2.COLOR_BGR2GRAY)
        gb = cv2.cvtColor(fb, cv2.COLOR_BGR2GRAY)
        h_true = np.asarray(inter_frame_homography(pa, pb, H, W), np.float64)

        corners = cv2.goodFeaturesToTrack(
            ga, maxCorners=200, qualityLevel=0.01, minDistance=10,
            mask=None, blockSize=3,
        ).reshape(-1, 2)
        true_dst = np.asarray(
            transform_points(jnp.asarray(h_true, jnp.float32), jnp.asarray(corners))
        )
        in_frame = (
            (true_dst[:, 0] >= 5) & (true_dst[:, 0] < W - 5)
            & (true_dst[:, 1] >= 5) & (true_dst[:, 1] < H - 5)
        )

        ref_pts, ref_st, _ = cv2.calcOpticalFlowPyrLK(
            ga, gb, corners.reshape(-1, 1, 2), None,
            winSize=(21, 21), maxLevel=3,
            criteria=(cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 0.01),
            minEigThreshold=1e-4,
        )
        ref_pts = ref_pts.reshape(-1, 2)
        ref_st = ref_st.reshape(-1).astype(bool)

        pyr_a = build_pyramid(jnp.asarray(ga, jnp.float32), 3)
        pyr_b = build_pyramid(jnp.asarray(gb, jnp.float32), 3)
        res = lk_track(pyr_a, pyr_b, jnp.asarray(corners), jnp.ones(len(corners), bool))
        ours_pts = np.asarray(res.points)
        ours_st = np.asarray(res.status)

        sel_ours = ours_st & in_frame
        sel_ref = ref_st & in_frame
        e_ours = np.linalg.norm(ours_pts[sel_ours] - true_dst[sel_ours], axis=-1)
        e_ref = np.linalg.norm(ref_pts[sel_ref] - true_dst[sel_ref], axis=-1)

        assert sel_ours.mean() > 0.8
        assert np.median(e_ours) < 0.5
        assert (e_ours < 2.0).mean() > 0.9
        # non-inferiority vs OpenCV on the identical problem
        assert (e_ours < 0.5).mean() >= (e_ref < 0.5).mean() - 0.05

    def test_known_translation(self):
        ga, _ = sim_pair()
        shift = np.float32([[1, 0, 3.25], [0, 1, -2.5]])
        gb = cv2.warpAffine(ga.astype(np.float32), shift, (W, H)).astype(np.uint8)
        corners = cv2.goodFeaturesToTrack(ga, 150, 0.01, 10).reshape(-1, 2)
        keep = (
            (corners[:, 0] > 30) & (corners[:, 0] < W - 30)
            & (corners[:, 1] > 30) & (corners[:, 1] < H - 30)
        )
        corners = corners[keep]

        pyr_a = build_pyramid(jnp.asarray(ga, jnp.float32), 3)
        pyr_b = build_pyramid(jnp.asarray(gb, jnp.float32), 3)
        res = lk_track(pyr_a, pyr_b, jnp.asarray(corners), jnp.ones(len(corners), bool))
        st = np.asarray(res.status)
        flow = np.asarray(res.points)[st] - corners[st]
        assert st.mean() > 0.8
        np.testing.assert_allclose(np.median(flow, axis=0), [3.25, -2.5], atol=0.1)

    def test_lost_points_flagged(self):
        ga, gb = sim_pair()
        # points in a flat synthetic region + out of bounds
        flat = np.full((H, W), 128, np.uint8)
        pts = np.array([[50.0, 50.0], [630.0, 350.0], [5.0, 5.0]], np.float32)
        pyr_a = build_pyramid(jnp.asarray(flat, jnp.float32), 3)
        pyr_b = build_pyramid(jnp.asarray(flat, jnp.float32), 3)
        res = lk_track(pyr_a, pyr_b, jnp.asarray(pts), jnp.ones(3, bool))
        assert not np.any(np.asarray(res.status))  # no texture -> min-eig fail

    def test_masked_input_stays_masked(self):
        ga, gb = sim_pair()
        pts = np.array([[100.0, 100.0], [200.0, 200.0]], np.float32)
        pyr_a = build_pyramid(jnp.asarray(ga, jnp.float32), 3)
        pyr_b = build_pyramid(jnp.asarray(gb, jnp.float32), 3)
        res = lk_track(pyr_a, pyr_b, jnp.asarray(pts), jnp.asarray([True, False]))
        assert not bool(res.status[1])
        np.testing.assert_allclose(res.points[1], pts[1])  # untouched


class TestCv2ExactTracker:
    def test_matches_cv2_endpoints(self):
        """LKConfig(method='cv2exact') — gradient-descent LK with OpenCV's
        iteration schedule — must agree with cv2.calcOpticalFlowPyrLK
        endpoints to sub-0.1px median on identical corners (the fidelity
        referee used by bench.py's reference-compat drift gate)."""
        from video_stabilization.sim import move_right

        tex = make_default_texture(jax.random.key(0), size=512)
        pa = DEFAULT_APP_PARAMS
        pb = roll_clockwise(move_right(pa, 0.3), 0.25)
        ga = cv2.cvtColor(np.asarray(render_frame(tex, pa, H, W)), cv2.COLOR_BGR2GRAY)
        gb = cv2.cvtColor(np.asarray(render_frame(tex, pb, H, W)), cv2.COLOR_BGR2GRAY)
        corners = cv2.goodFeaturesToTrack(ga, 150, 0.01, 10).reshape(-1, 2)
        ref_pts, ref_st, _ = cv2.calcOpticalFlowPyrLK(
            ga, gb, corners.reshape(-1, 1, 2), None, winSize=(21, 21),
            maxLevel=3,
            criteria=(cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 0.01),
            minEigThreshold=1e-4,
        )
        ref_pts = ref_pts.reshape(-1, 2)
        ref_st = ref_st.reshape(-1).astype(bool)

        pyr_a = build_pyramid(jnp.asarray(ga, jnp.float32), 3)
        pyr_b = build_pyramid(jnp.asarray(gb, jnp.float32), 3)
        res = lk_track(pyr_a, pyr_b, jnp.asarray(corners),
                       jnp.ones(len(corners), bool), LKConfig(method="cv2exact"))
        sel = np.asarray(res.status) & ref_st
        d = np.linalg.norm(np.asarray(res.points)[sel] - ref_pts[sel], axis=-1)
        assert sel.sum() > 100
        assert np.median(d) < 0.05
        assert (d < 0.2).mean() > 0.85


class TestCv2ExactGFTT:
    def test_greedy_fixpoint_equals_sequential(self):
        """The parallel priority-MIS fixpoint must reproduce OpenCV's
        sequential greedy suppression decisions exactly (including the
        rounded-cell 3x3-neighborhood quirk) on adversarial random input."""
        from video_stabilization.ops.gftt import _greedy_cv2exact

        rng = np.random.default_rng(7)
        m, k, min_dist = 500, 120, 7.3
        pts = rng.integers(0, 120, size=(m, 2)).astype(np.float32)
        resp = rng.permutation(m).astype(np.float32) + 1.0
        order = np.argsort(-resp)
        pts, resp = pts[order], resp[order]

        # sequential replica of cv2's loop (grid of round(minDistance) cells,
        # 3x3 neighborhood check, strict < minDistance^2 rejection)
        cell = int(round(min_dist))
        accepted = []
        for i in range(m):
            cx, cy = int(pts[i, 0]) // cell, int(pts[i, 1]) // cell
            ok = True
            for j in accepted:
                jx, jy = int(pts[j, 0]) // cell, int(pts[j, 1]) // cell
                if abs(jx - cx) <= 1 and abs(jy - cy) <= 1:
                    d2 = ((pts[i] - pts[j]) ** 2).sum()
                    if d2 < min_dist * min_dist:
                        ok = False
                        break
            if ok:
                accepted.append(i)
                if len(accepted) == k:
                    break
        want = pts[accepted]

        got = _greedy_cv2exact(
            jnp.asarray(pts), jnp.asarray(resp), jnp.ones(m, bool),
            min_dist, k,
        )
        got_pts = np.asarray(got.points)[np.asarray(got.mask)]
        assert got_pts.shape == want.shape
        np.testing.assert_array_equal(got_pts, want)

    def test_matches_cv2_corner_list(self):
        """selection='cv2exact' must return (essentially) cv2's corner list:
        same pipeline, same greedy decisions; residual mismatches only from
        float near-ties in the response map."""
        ga, _ = sim_pair()
        cfg = GFTTConfig(max_features=1300, selection="cv2exact")
        ours = good_features_to_track(jnp.asarray(ga, jnp.float32), cfg)
        pts = np.asarray(ours.points)[np.asarray(ours.mask)]

        ref = cv2.goodFeaturesToTrack(
            ga, maxCorners=1300, qualityLevel=0.01, minDistance=5.0,
            mask=None, blockSize=3,
        ).reshape(-1, 2)

        assert abs(len(pts) - len(ref)) <= max(3, int(0.01 * len(ref)))
        set_ours = {(float(x), float(y)) for x, y in pts}
        set_ref = {(float(x), float(y)) for x, y in ref}
        overlap = len(set_ours & set_ref) / max(len(set_ref), 1)
        assert overlap > 0.97, f"corner-set overlap {overlap:.3f}"

    def test_dispatch_from_config(self):
        ga, _ = sim_pair()
        cfg = GFTTConfig(max_features=256, selection="cv2exact")
        out = jax.jit(lambda x: good_features_to_track(x, cfg))(
            jnp.asarray(ga, jnp.float32)
        )
        assert out.points.shape == (256, 2)
        # min-distance actually enforced (exact semantics, not cells)
        p = np.asarray(out.points)[np.asarray(out.mask)]
        from scipy.spatial import cKDTree

        d, _ = cKDTree(p).query(p, k=2)
        assert d[:, 1].min() >= 5.0 - 1e-6


class TestIndependentMotion:
    """The dense tracker must not hand independently-moving points to RANSAC
    as inliers (ADVICE r2: they would snap to the global motion and become
    perfect inliers; reference semantics = per-point LK + RANSAC rejection,
    src/stabilizer.cpp:170-275)."""

    def _scene(self):
        ga0, _ = sim_pair()
        shift = np.float32([[1, 0, 3.0], [0, 1, -2.0]])
        gb = cv2.warpAffine(ga0.astype(np.float32), shift, (W, H),
                            borderMode=cv2.BORDER_REPLICATE)
        # textured foreground block moving (+12, +9) relative to the scene
        rng = np.random.default_rng(3)
        block = cv2.GaussianBlur(
            rng.integers(0, 255, (64, 64)).astype(np.uint8), (3, 3), 0.8
        )
        y0, x0 = 140, 260
        ga = ga0.copy()
        ga[y0:y0 + 64, x0:x0 + 64] = block
        gb = gb.astype(np.uint8)
        gb[y0 - 2 + 9:y0 + 62 + 9, x0 + 3 + 12:x0 + 67 + 12] = block
        return ga, gb, (y0, x0)

    def test_dense_drops_moving_object_points(self):
        ga, gb, (y0, x0) = self._scene()
        corners = cv2.goodFeaturesToTrack(ga, 400, 0.01, 10).reshape(-1, 2)
        on_obj = (
            (corners[:, 0] >= x0 + 4) & (corners[:, 0] < x0 + 60)
            & (corners[:, 1] >= y0 + 4) & (corners[:, 1] < y0 + 60)
        )
        margin = 30
        on_bg = ~(
            (corners[:, 0] >= x0 - margin) & (corners[:, 0] < x0 + 64 + margin)
            & (corners[:, 1] >= y0 - margin) & (corners[:, 1] < y0 + 64 + margin)
        ) & (
            (corners[:, 0] > 30) & (corners[:, 0] < W - 30)
            & (corners[:, 1] > 30) & (corners[:, 1] < H - 30)
        )
        assert on_obj.sum() >= 5

        pyr_a = build_pyramid(jnp.asarray(ga, jnp.float32), 3)
        pyr_b = build_pyramid(jnp.asarray(gb, jnp.float32), 3)
        res = lk_track(pyr_a, pyr_b, jnp.asarray(corners),
                       jnp.ones(len(corners), bool), LKConfig(method="dense"))
        st = np.asarray(res.status)

        # moving-object points must be dropped, background points kept
        assert st[on_obj].mean() < 0.3, (
            f"{st[on_obj].mean():.0%} of moving-object points passed"
        )
        assert st[on_bg].mean() > 0.6
        flow = np.asarray(res.points)[st & on_bg] - corners[st & on_bg]
        np.testing.assert_allclose(np.median(flow, axis=0), [3.0, -2.0],
                                   atol=0.15)

    def test_global_fit_unbiased_by_object(self):
        from video_stabilization.motion.ransac import (
            estimate_similarity_ransac,
        )

        ga, gb, _ = self._scene()
        corners = cv2.goodFeaturesToTrack(ga, 400, 0.01, 10).reshape(-1, 2)
        pyr_a = build_pyramid(jnp.asarray(ga, jnp.float32), 3)
        pyr_b = build_pyramid(jnp.asarray(gb, jnp.float32), 3)
        res = lk_track(pyr_a, pyr_b, jnp.asarray(corners),
                       jnp.ones(len(corners), bool), LKConfig(method="dense"))
        fit = estimate_similarity_ransac(
            jnp.asarray(corners), res.points, res.status, jax.random.key(0)
        )
        h = np.asarray(fit.h)
        assert bool(fit.valid)
        np.testing.assert_allclose(h[:2, 2], [3.0, -2.0], atol=0.2)
        np.testing.assert_allclose(h[:2, :2], np.eye(2), atol=5e-3)
