"""Engine tests: smoothing math, lock modes, end-to-end stabilization.

End-to-end tests run the full jitted step on simulator footage with known
camera motion (SURVEY.md §4: the simulator is the universal fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.config import (
    GFTTConfig,
    LKConfig,
    ORBConfig,
    RansacConfig,
    SIFTConfig,
    StabilizationMode,
    StabilizerConfig,
)
from video_stabilization.engine import (
    Stabilizer,
    init_carry,
    make_step_fn,
    smoothing_homography,
)
from video_stabilization.sim import (
    DEFAULT_APP_PARAMS,
    make_default_texture,
    render_frame,
    shake_trajectory,
)

FH, FW = 240, 320


def small_config(past=8, future=4, compat=False):
    return StabilizerConfig(
        past_frames=past,
        future_frames=future,
        working_height=120,
        frame_height=FH,
        frame_width=FW,
        gftt=GFTTConfig(max_features=256),
        lk=LKConfig(max_iters=30),
        ransac=RansacConfig(num_hypotheses=128),
        # small test frames: the reference's relative-size filter assumes
        # >=310px working height for ORB's 31px patches — relax it here, and
        # lower the FAST threshold (tuned for 360p content) so the 120px
        # working image yields enough corners to keep RANSAC's 10-match
        # minimum comfortably met (threshold 20 leaves ~80 keypoints and
        # 6-7 Lowe matches — a borderline lock where bit-level descriptor
        # shifts flip frames between success and the sticky fallback).
        orb=ORBConfig(max_features=512, n_levels=4, max_keypoint_size_ratio=0.5,
                      fast_threshold=8),
        sift=SIFTConfig(max_features=256, max_keypoint_size_ratio=0.5),
        reference_compat=compat,
    )


def np_reference_smoothing(transforms, p, compat):
    """Literal numpy replica of the reference's smoothing loops
    (src/stabilizer.cpp:793-852) for cross-checking."""
    n = len(transforms)
    h_avg = np.zeros((3, 3))
    count = 0
    h_accum = np.eye(3)
    for i in range(p, 0, -1):
        h_accum = np.linalg.inv(transforms[i - 1]) @ h_accum
        h_avg += h_accum
        count += 1
    h_accum = np.eye(3)
    bound = n - 1 if compat else n
    for i in range(p, bound):
        if compat:
            h_accum = h_accum @ transforms[i]
        else:
            h_accum = transforms[i] @ h_accum
        h_avg += h_accum
        count += 1
    if not compat:
        h_avg += np.eye(3)
        count += 1
    if count == 0:
        return np.eye(3)
    return h_avg / count


def random_rigid_transforms(rng, n):
    ts = []
    for _ in range(n):
        ang = rng.uniform(-0.02, 0.02)
        c, s = np.cos(ang), np.sin(ang)
        tx, ty = rng.uniform(-3, 3, 2)
        ts.append(np.array([[c, -s, tx], [s, c, ty], [0, 0, 1]], np.float32))
    return ts


class TestSmoothing:
    @pytest.mark.parametrize("compat", [False, True])
    @pytest.mark.parametrize("p,n", [(4, 9), (0, 9), (8, 9), (3, 5), (0, 1)])
    def test_matches_reference_replica(self, rng, compat, p, n):
        wm1 = 12  # array capacity > n
        ts = random_rigid_transforms(rng, n)
        arr = np.broadcast_to(np.eye(3, dtype=np.float32), (wm1, 3, 3)).copy()
        arr[wm1 - n:] = ts
        tvalid = np.zeros(wm1, bool)
        tvalid[wm1 - n:] = True

        q = smoothing_homography(
            jnp.asarray(arr), jnp.asarray(tvalid), jnp.asarray(p),
            jnp.asarray(n), reference_compat=compat,
        )
        expected = np_reference_smoothing(ts, p, compat)
        np.testing.assert_allclose(np.asarray(q), expected, atol=2e-4)

    def test_empty_window_identity(self):
        arr = jnp.broadcast_to(jnp.eye(3), (12, 3, 3))
        q = smoothing_homography(arr, jnp.zeros(12, bool), jnp.asarray(0), jnp.asarray(0))
        # fixed mode: only the +I term -> exactly identity
        np.testing.assert_allclose(np.asarray(q), np.eye(3), atol=1e-6)

    def test_static_shake_averages_out(self, rng):
        """Pure translational shake around zero: Q's translation ~ mean
        displacement to neighbours (a low-pass of the trajectory)."""
        n = 10
        offsets = rng.uniform(-5, 5, (n + 1, 2))  # absolute positions
        ts = []
        for i in range(n):
            d = offsets[i + 1] - offsets[i]
            ts.append(np.array([[1, 0, d[0]], [0, 1, d[1]], [0, 0, 1]], np.float32))
        arr = np.stack(ts)
        q = smoothing_homography(
            jnp.asarray(arr), jnp.ones(n, bool), jnp.asarray(5), jnp.asarray(n)
        )
        # chained products map presentation frame 5 into each neighbour frame;
        # translation of the average = mean of (offset_j - offset_5)
        expected_t = np.mean(offsets - offsets[5], axis=0)
        np.testing.assert_allclose(np.asarray(q)[:2, 2], expected_t, atol=1e-3)


@pytest.fixture(scope="module")
def footage():
    tex = make_default_texture(jax.random.key(0), size=256)
    base = DEFAULT_APP_PARAMS
    traj = shake_trajectory(jax.random.key(5), 30, base,
                            pos_amplitude=0.004, roll_amplitude=0.3)
    frames = jax.vmap(lambda p: render_frame(tex, p, FH, FW))(traj)
    return np.asarray(frames)


class TestEngineEndToEnd:
    def test_first_frame_passthrough(self, footage):
        cfg = small_config()
        stab = Stabilizer(cfg)
        out = stab.stabilize_frame(footage[0])
        np.testing.assert_array_equal(np.asarray(out), footage[0])

    def test_smoothing_reduces_shake(self, footage):
        cfg = small_config(past=6, future=4)
        step = make_step_fn(cfg)
        carry = init_carry(cfg, int(StabilizationMode.GLOBAL_SMOOTHING), jax.random.key(0))
        outs = []
        for f in footage:
            carry, (out, _) = step(carry, jnp.asarray(f))
            outs.append(np.asarray(out))
        outs = np.stack(outs)

        # After warm-up, compare inter-frame jitter (central crop) of the
        # stabilized stream vs the raw stream (aligned by the future delay).
        delay = cfg.future_frames
        crop = (slice(60, 180), slice(80, 240))
        raw = footage[: len(footage) - delay].astype(np.float32)
        stabv = outs[delay:].astype(np.float32)
        jitter_raw = np.abs(np.diff(raw[10:, *crop], axis=0)).mean()
        jitter_stab = np.abs(np.diff(stabv[10:, *crop], axis=0)).mean()
        assert jitter_stab < 0.75 * jitter_raw

    def test_accumulated_lock_freezes_view(self, footage):
        cfg = small_config(past=6, future=2)
        step = make_step_fn(cfg)
        carry = init_carry(cfg, int(StabilizationMode.ACCUMULATED_FULL_LOCK),
                           jax.random.key(0))
        outs = []
        for f in footage:
            carry, (out, _) = step(carry, jnp.asarray(f))
            outs.append(np.asarray(out))
        outs = np.stack(outs).astype(np.float32)

        # Once locked, consecutive outputs should barely change even though
        # the camera shakes: compare late-stream jitter to raw jitter.
        crop = (slice(60, 180), slice(80, 240))
        delay = cfg.future_frames
        raw = footage[: len(footage) - delay].astype(np.float32)
        jitter_raw = np.abs(np.diff(raw[10:, *crop], axis=0)).mean()
        jitter_lock = np.abs(np.diff(outs[10:, *crop], axis=0)).mean()
        assert jitter_lock < 0.4 * jitter_raw

    def test_mode_switch_midstream(self, footage):
        cfg = small_config(past=6, future=2)
        stab = Stabilizer(cfg, StabilizationMode.GLOBAL_SMOOTHING)
        for f in footage[:10]:
            stab.stabilize_frame(f)
        stab.set_stabilization_mode(StabilizationMode.ACCUMULATED_FULL_LOCK)
        assert not bool(stab.carry.accum_active)
        for f in footage[10:20]:
            out = stab.stabilize_frame(f)
        assert bool(stab.carry.accum_active)
        assert out.shape == footage[0].shape

    def test_carry_counts(self, footage):
        cfg = small_config(past=3, future=2)
        stab = Stabilizer(cfg)
        for f in footage[:10]:
            stab.stabilize_frame(f)
        assert int(stab.carry.n) == 10
        assert bool(jnp.all(stab.carry.tvalid))  # window (W-1=5) full

class TestLockDecomposition:
    """TRANSLATION_LOCK / ROTATION_LOCK against analytic ground truth.

    The reference leaves both modes as no-ops (src/stabilizer.cpp:790,
    README "[Not fully implemented yet]"); this engine implements the
    intended decomposition split (the abandoned block at :339-436).  Footage
    is synthesized by warping one textured frame with KNOWN rigid motions,
    so the expected correction is exact: for the locked component,
    ``last_h @ A_true`` (output view of the original content) must be
    ~identity; for the free component, ``last_h`` itself must be ~identity.
    """

    N, PAST, FUT = 12, 6, 2
    TOL = 2.0          # px mean corner drift at working res (est. noise)

    @staticmethod
    def _make_footage(kind):
        import cv2

        tex = np.asarray(
            render_frame(make_default_texture(jax.random.key(3), 256),
                         DEFAULT_APP_PARAMS, FH, FW)
        )
        frames, ms = [], []
        for i in range(TestLockDecomposition.N):
            if kind == "roll":
                m = cv2.getRotationMatrix2D((FW / 2, FH / 2), 0.6 * i, 1.0)
            else:
                m = np.float32([[1, 0, 1.6 * i], [0, 1, -1.2 * i]])
            frames.append(cv2.warpAffine(tex, m, (FW, FH),
                                         borderMode=cv2.BORDER_REFLECT))
            ms.append(np.vstack([m, [0, 0, 1]]).astype(np.float64))
        return frames, ms

    @classmethod
    def _run(cls, kind, mode):
        frames, ms = cls._make_footage(kind)
        cfg = small_config(past=cls.PAST, future=cls.FUT)
        stab = Stabilizer(cfg, mode)
        for f in frames:
            stab.stabilize_frame(f)
        # analytic accumulated motion anchor(frame 0) -> presentation frame,
        # scaled to working resolution (translation scales; rotation doesn't)
        pres = cls.N - 1 - cls.FUT
        s = cfg.working_height / FH
        scale = np.diag([s, s, 1.0])
        a_true = scale @ ms[pres] @ np.linalg.inv(ms[0]) @ np.linalg.inv(scale)
        return np.asarray(stab.carry.last_h, np.float64), a_true, cfg

    @staticmethod
    def _drift(ha, hb, cfg):
        wh, ww = cfg.working_size
        c = np.array([[0, 0, 1], [ww, 0, 1], [ww, wh, 1], [0, wh, 1]], float).T
        pa = ha @ c
        pb = hb @ c
        return np.abs(pa[:2] / pa[2] - pb[:2] / pb[2]).mean()

    def test_rotation_lock_cancels_roll(self):
        h, a_true, cfg = self._run("roll", StabilizationMode.ROTATION_LOCK)
        # locked: the composed output motion is ~static
        assert self._drift(h @ a_true, np.eye(3), cfg) < self.TOL
        # and the correction is substantial (raw roll moves corners a lot)
        assert self._drift(a_true, np.eye(3), cfg) > 2.5 * self.TOL

    def test_translation_lock_passes_roll_through(self):
        h, _, cfg = self._run("roll", StabilizationMode.TRANSLATION_LOCK)
        # free component: pure roll has no translation to cancel
        assert self._drift(h, np.eye(3), cfg) < self.TOL

    def test_translation_lock_cancels_translation(self):
        h, a_true, cfg = self._run("shift", StabilizationMode.TRANSLATION_LOCK)
        assert self._drift(h @ a_true, np.eye(3), cfg) < self.TOL
        assert self._drift(a_true, np.eye(3), cfg) > 2.5 * self.TOL

    def test_rotation_lock_passes_translation_through(self):
        h, _, cfg = self._run("shift", StabilizationMode.ROTATION_LOCK)
        assert self._drift(h, np.eye(3), cfg) < self.TOL


class TestRegistrationLocks:
    """ORB/SIFT registration lock modes end-to-end (reference:
    src/stabilizer.cpp:440-788): the view must freeze onto the reference
    frame captured at mode entry, with no cumulative drift."""

    def _run_lock(self, footage, mode):
        cfg = small_config(past=4, future=2)
        stab = Stabilizer(cfg, mode)
        outs = [np.asarray(stab.stabilize_frame(f)) for f in footage]
        return np.stack(outs).astype(np.float32), stab

    def _jitter(self, seq, crop=(slice(60, 180), slice(80, 240))):
        return np.abs(np.diff(seq[8:, crop[0], crop[1]], axis=0)).mean()

    def test_orb_lock_freezes_view(self, footage):
        outs, stab = self._run_lock(
            footage[:20], StabilizationMode.ORB_FULL_LOCK
        )
        raw = footage[:18].astype(np.float32)
        assert bool(stab.carry.orb_ref.is_set)
        assert self._jitter(outs) < 0.6 * self._jitter(raw)

    def test_sift_lock_freezes_view(self, footage):
        outs, stab = self._run_lock(
            footage[:20], StabilizationMode.SIFT_FULL_LOCK
        )
        raw = footage[:18].astype(np.float32)
        assert bool(stab.carry.sift_ref.is_set)
        assert self._jitter(outs) < 0.6 * self._jitter(raw)

    def test_mode_switch_recaptures_reference(self, footage):
        cfg = small_config(past=4, future=2)
        stab = Stabilizer(cfg, StabilizationMode.ORB_FULL_LOCK)
        for f in footage[:8]:
            stab.stabilize_frame(f)
        assert bool(stab.carry.orb_ref.is_set)
        stab.set_stabilization_mode(StabilizationMode.GLOBAL_SMOOTHING)
        assert not bool(stab.carry.orb_ref.is_set)  # lock state cleared
        stab.set_stabilization_mode(StabilizationMode.ORB_FULL_LOCK)
        stab.stabilize_frame(footage[8])
        assert bool(stab.carry.orb_ref.is_set)  # new reference captured


class TestStaticMode:
    """config.static_mode pins the lock branch at trace time (the stream-
    batched throughput path — a vmapped lax.switch would run every branch);
    it must be numerically identical to the dynamic switch."""

    def test_static_matches_dynamic(self, footage):
        import dataclasses

        cfg_dyn = small_config(past=4, future=2)
        cfg_static = dataclasses.replace(
            cfg_dyn, static_mode=int(StabilizationMode.TRANSLATION_LOCK))
        a = Stabilizer(cfg_dyn, StabilizationMode.TRANSLATION_LOCK, seed=3)
        b = Stabilizer(cfg_static, StabilizationMode.TRANSLATION_LOCK, seed=3)
        for f in footage[:8]:
            out_a = a.stabilize_frame(f)
            out_b = b.stabilize_frame(f)
        np.testing.assert_allclose(np.asarray(a.carry.last_h),
                                   np.asarray(b.carry.last_h), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(out_a), np.asarray(out_b))


class TestScanApi:
    """make_scan_fn / Stabilizer.stabilize_clip: a whole-clip lax.scan must
    be numerically identical to feeding frames one at a time."""

    def test_scan_matches_per_frame(self, footage):
        from video_stabilization.engine import make_scan_fn

        cfg = small_config(past=4, future=2)
        n = 8

        step = make_step_fn(cfg)
        carry = init_carry(cfg, int(StabilizationMode.GLOBAL_SMOOTHING),
                           jax.random.key(7))
        outs_step = []
        for f in footage[:n]:
            carry, (out, _) = step(carry, jnp.asarray(f))
            outs_step.append(np.asarray(out))

        scan = make_scan_fn(cfg)
        carry2 = init_carry(cfg, int(StabilizationMode.GLOBAL_SMOOTHING),
                            jax.random.key(7))
        carry2, (outs, valid) = scan(carry2, jnp.asarray(footage[:n]))
        np.testing.assert_array_equal(np.asarray(outs), np.stack(outs_step))
        np.testing.assert_allclose(np.asarray(carry.last_h),
                                   np.asarray(carry2.last_h), atol=1e-6)
