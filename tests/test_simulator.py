"""Simulator tests: renderer geometry, movement, analytic homography truth.

The analytic-homography consistency test is the linchpin of the whole test
strategy: if warping frame A by the analytic inter-frame homography
reproduces frame B, then the analytic H is a valid ground truth for every
downstream motion-estimation test (SURVEY.md §4).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from video_stabilization.sim import (
    CameraParams,
    DEFAULT_APP_PARAMS,
    inter_frame_homography,
    make_default_texture,
    move_backward,
    move_forward,
    move_right,
    move_up,
    plane_to_pixel_homography,
    render_frame,
    roll_clockwise,
    rotation_matrix,
    shake_trajectory,
)

H, W = 360, 640


def app_params():
    # Demo-app start pose (reference: src/main.cpp:29-36), camera looking
    # straight down at the floor from z=0.7.
    return DEFAULT_APP_PARAMS


class TestRotationMatrix:
    def test_orthonormal(self):
        r = rotation_matrix(jnp.float32(10.0), jnp.float32(105.0), jnp.float32(180.0))
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-6)

    def test_identity_at_zero(self):
        r = rotation_matrix(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
        np.testing.assert_allclose(r, np.eye(3), atol=1e-7)

    def test_composition_order(self):
        # R(pan only) must be a pure Y rotation, etc.
        r = rotation_matrix(jnp.float32(90.0), jnp.float32(0.0), jnp.float32(0.0))
        np.testing.assert_allclose(r @ np.array([0, 0, 1.0]), [1, 0, 0], atol=1e-6)


class TestRenderer:
    def test_shapes_dtype(self):
        tex = make_default_texture(jax.random.key(0))
        frame = render_frame(tex, app_params(), H, W)
        assert frame.shape == (H, W, 3)
        assert frame.dtype == jnp.uint8

    def test_down_camera_sees_floor_not_sky(self):
        tex = make_default_texture(jax.random.key(0))
        frame = np.asarray(render_frame(tex, app_params(), H, W))
        sky = np.all(frame == np.array([230, 216, 173]), axis=-1)
        assert sky.mean() < 0.01  # looking straight down: no sky

    def test_horizon_split(self):
        # tilt 90 deg = horizontal view: half sky, half floor. With roll=180
        # the image is upside-down, so the sky lands in the BOTTOM rows.
        tex = make_default_texture(jax.random.key(0))
        p = CameraParams.create(position=(0.0, 0.0, 1.0), tilt=90.0, roll=180.0)
        frame = np.asarray(render_frame(tex, p, H, W))
        sky = np.all(frame == np.array([230, 216, 173]), axis=-1)
        assert sky[-H // 4 :].mean() > 0.99    # bottom rows all sky
        assert sky[: H // 4].mean() < 0.01     # top rows all floor
        np.testing.assert_allclose(sky.mean(), 0.5, atol=0.01)

    def test_jit_deterministic(self):
        tex = make_default_texture(jax.random.key(0))
        f = jax.jit(lambda t, p: render_frame(t, p, H, W))
        a = np.asarray(f(tex, app_params()))
        b = np.asarray(f(tex, app_params()))
        np.testing.assert_array_equal(a, b)

    def test_vmap_over_trajectory(self):
        tex = make_default_texture(jax.random.key(0))
        traj = shake_trajectory(jax.random.key(1), 4, app_params())
        frames = jax.vmap(lambda p: render_frame(tex, p, H, W))(traj)
        assert frames.shape == (4, H, W, 3)
        # shake actually moves the image
        assert not np.array_equal(np.asarray(frames[0]), np.asarray(frames[3]))


class TestMovement:
    def test_forward_moves_along_view_axis(self):
        p = app_params()
        p2 = move_forward(p, 1.0)
        # looking straight down (tilt=180): forward is -z
        delta = np.asarray(p2.position - p.position)
        np.testing.assert_allclose(delta, [0, 0, -0.1], atol=1e-6)

    def test_backward_inverse_of_forward(self):
        p = app_params()
        p2 = move_backward(move_forward(p, 1.0), 1.0)
        np.testing.assert_allclose(p2.position, p.position, atol=1e-7)

    def test_roll(self):
        p = roll_clockwise(app_params(), 1.0)
        np.testing.assert_allclose(p.roll, 180.0 - 2.0)

    def test_right_and_up_orthogonal_to_view(self):
        p = app_params()
        dr = np.asarray(move_right(p, 1.0).position - p.position)
        du = np.asarray(move_up(p, 1.0).position - p.position)
        assert abs(dr @ du) < 1e-8
        assert abs(dr[2]) < 1e-6  # looking down: right/up moves are horizontal


class TestAnalyticHomography:
    def test_projection_matches_renderer(self):
        """G maps world floor points to the pixels where the renderer drew them."""
        p = app_params()
        g = np.asarray(plane_to_pixel_homography(p, H, W))
        # center pixel ray: straight down from (0.5,-0.3,0.7) hits floor at
        # (0.5,-0.3); project it back
        pt = g @ np.array([0.5, -0.3, 1.0])
        pt = pt[:2] / pt[2]
        np.testing.assert_allclose(pt, [W / 2.0, H / 2.0], atol=1e-3)

    def test_warp_consistency(self):
        """warp(frame_a, H_ab) ≈ frame_b away from sky/borders."""
        tex = make_default_texture(jax.random.key(0), size=512)
        pa = app_params()
        pb = roll_clockwise(move_right(pa, 0.5), 1.0)  # small rigid-ish motion
        fa = np.asarray(render_frame(tex, pa, H, W))
        fb = np.asarray(render_frame(tex, pb, H, W))
        h_ab = np.asarray(inter_frame_homography(pa, pb, H, W), np.float64)

        warped = cv2.warpPerspective(fa, h_ab, (W, H), flags=cv2.INTER_LINEAR)
        inner = (slice(40, H - 40), slice(40, W - 40))
        diff = np.abs(
            warped[inner].astype(np.float32) - fb[inner].astype(np.float32)
        )
        # nearest-texel rendering causes ±1-texel speckle; the mean must be
        # small and the majority of pixels near-exact.
        assert diff.mean() < 15.0
        assert (diff.max(axis=-1) < 20).mean() > 0.85

    def test_identity_for_same_pose(self):
        p = app_params()
        h = np.asarray(inter_frame_homography(p, p, H, W))
        np.testing.assert_allclose(h, np.eye(3), atol=1e-3)

    def test_roll_only_motion_is_rotation_about_center(self):
        from video_stabilization.motion import decompose_homography

        pa = app_params()
        pb = pa._replace(roll=pa.roll + 2.0)
        h = inter_frame_homography(pa, pb, H, W)
        params, valid = decompose_homography(h, jnp.array([W / 2.0, H / 2.0]))
        assert bool(valid)
        np.testing.assert_allclose(np.rad2deg(float(params.theta)), 2.0, atol=1e-3)
        np.testing.assert_allclose(params.scale, 1.0, atol=1e-5)
        np.testing.assert_allclose(params.t, 0.0, atol=1e-2)
