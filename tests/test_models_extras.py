"""Motion-model registry, compositing, and checkpoint tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.models import MotionModel, fit_homography_dlt, fit_motion
from video_stabilization.motion.similarity import transform_points
from video_stabilization.ops.compositing import (
    compute_translation_shift,
    copy_feathered,
    warped_mask,
)


class TestMotionModels:
    def _corr(self, rng, h_true, n=100):
        src = rng.uniform(20, 300, (n, 2)).astype(np.float32)
        dst = np.asarray(transform_points(jnp.asarray(h_true), jnp.asarray(src)))
        return jnp.asarray(src), jnp.asarray(dst), jnp.ones(n)

    def test_homography_dlt_exact(self, rng):
        h_true = np.array(
            [[1.05, 0.02, -8.0], [-0.03, 0.98, 5.0], [1e-4, -5e-5, 1.0]],
            np.float32,
        )
        src, dst, w = self._corr(rng, h_true)
        h, ok = fit_homography_dlt(src, dst, w)
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(h), h_true, atol=2e-3)

    def test_homography_masked_outliers(self, rng):
        h_true = np.array(
            [[0.99, -0.05, 4.0], [0.05, 1.01, -2.0], [0, 0, 1.0]], np.float32
        )
        src, dst, _ = self._corr(rng, h_true, n=80)
        dst = np.array(dst)
        dst[60:] += 50.0
        w = np.ones(80, np.float32)
        w[60:] = 0.0
        h, ok = fit_homography_dlt(src, jnp.asarray(dst), jnp.asarray(w))
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(h), h_true, atol=5e-3)

    @pytest.mark.parametrize("model", list(MotionModel))
    def test_all_models_fit_rigid_motion(self, rng, model):
        ang = 0.04
        c, s = np.cos(ang), np.sin(ang)
        h_true = np.array([[c, -s, 6.0], [s, c, -3.0], [0, 0, 1]], np.float32)
        src, dst, w = self._corr(rng, h_true)
        center = jnp.array([160.0, 120.0])
        h, ok = fit_motion(model, src, dst, w, center)
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(h), h_true, atol=5e-3)

    def test_affine_recovers_shear(self, rng):
        h_true = np.array([[1.02, 0.08, 2.0], [0.01, 0.97, -1.0], [0, 0, 1]],
                          np.float32)
        src, dst, w = self._corr(rng, h_true)
        h, ok = fit_motion(MotionModel.AFFINE, src, dst, w, jnp.zeros(2))
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(h), h_true, atol=1e-3)


class TestCompositing:
    def test_translation_shift_identity_rotation(self):
        t = compute_translation_shift(jnp.float32(1.0), jnp.float32(0.0),
                                      jnp.array([100.0, 50.0]))
        np.testing.assert_allclose(np.asarray(t), [0.0, 0.0], atol=1e-6)

    def test_warped_mask_identity(self):
        m = np.asarray(warped_mask(jnp.eye(3), 40, 60))
        assert m[20, 30] and m[0, 0] and m[39, 59]

    def test_warped_mask_shift(self):
        h = jnp.asarray(np.array([[1, 0, 20.0], [0, 1, 0], [0, 0, 1]], np.float32))
        m = np.asarray(warped_mask(h, 40, 60))
        assert not m[20, 5]       # left strip now outside the warped frame
        assert m[20, 40]

    def test_copy_feathered_composites(self, rng):
        frame = jnp.asarray(rng.uniform(100, 200, (64, 80)).astype(np.float32))
        bg = jnp.zeros((64, 80), jnp.float32)
        h = jnp.asarray(np.array([[1, 0, 10.0], [0, 1, 0], [0, 0, 1]], np.float32))
        out = np.asarray(copy_feathered(frame, bg, h))
        # warped interior carries frame content; evacuated strip stays ~bg
        assert out[32, 50] > 50.0
        assert out[32, 2] < 30.0
        # second pass fades the old content where the new frame is absent
        out2 = np.asarray(copy_feathered(frame, jnp.asarray(out),
                                         jnp.eye(3)))
        assert np.isfinite(out2).all()


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        from video_stabilization.config import (
            GFTTConfig, LKConfig, RansacConfig, StabilizerConfig,
        )
        from video_stabilization.engine import Stabilizer, init_carry
        from video_stabilization.engine.checkpoint import load_carry, save_carry
        from video_stabilization.sim import (
            DEFAULT_APP_PARAMS, make_default_texture, render_frame,
        )

        cfg = StabilizerConfig(
            past_frames=3, future_frames=2, working_height=100,
            frame_height=120, frame_width=160,
            gftt=GFTTConfig(max_features=128),
            lk=LKConfig(max_iters=10),
            ransac=RansacConfig(num_hypotheses=64),
        )
        tex = make_default_texture(jax.random.key(0), size=128)
        frame = np.asarray(render_frame(tex, DEFAULT_APP_PARAMS, 120, 160))

        stab = Stabilizer(cfg)
        for _ in range(4):
            stab.stabilize_frame(frame)

        path = str(tmp_path / "carry.npz")
        save_carry(path, stab.carry)

        template = init_carry(cfg, 0, jax.random.key(0))
        restored = load_carry(path, template)
        assert int(restored.n) == int(stab.carry.n)
        np.testing.assert_array_equal(
            np.asarray(restored.transforms), np.asarray(stab.carry.transforms)
        )

        # resumed engine continues bit-identically
        stab2 = Stabilizer(cfg)
        stab2.carry = restored
        o1 = np.asarray(stab.stabilize_frame(frame))
        o2 = np.asarray(stab2.stabilize_frame(frame))
        np.testing.assert_array_equal(o1, o2)

    def test_shape_mismatch_raises(self, tmp_path):
        from video_stabilization.config import (
            GFTTConfig, LKConfig, RansacConfig, StabilizerConfig,
        )
        from video_stabilization.engine import init_carry
        from video_stabilization.engine.checkpoint import load_carry, save_carry

        cfg_a = StabilizerConfig(
            past_frames=3, future_frames=2, working_height=100,
            frame_height=120, frame_width=160,
            gftt=GFTTConfig(max_features=128), lk=LKConfig(max_iters=10),
            ransac=RansacConfig(num_hypotheses=64),
        )
        cfg_b = StabilizerConfig(
            past_frames=5, future_frames=2, working_height=100,
            frame_height=120, frame_width=160,
            gftt=GFTTConfig(max_features=128), lk=LKConfig(max_iters=10),
            ransac=RansacConfig(num_hypotheses=64),
        )
        path = str(tmp_path / "c.npz")
        save_carry(path, init_carry(cfg_a, 0, jax.random.key(0)))
        with pytest.raises(ValueError):
            load_carry(path, init_carry(cfg_b, 0, jax.random.key(0)))
