"""Behavioral-quirk parity tests (SURVEY.md appendix checklist).

Each quirk is replicated under ``reference_compat=True`` and (where we chose
to fix it) corrected otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.config import (
    GFTTConfig, LKConfig, ORBConfig, RansacConfig, SIFTConfig,
    StabilizationMode, StabilizerConfig,
)
from video_stabilization.engine import Stabilizer
from video_stabilization.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, roll_clockwise,
    shake_trajectory,
)

FH, FW = 240, 320


def cfg_(compat=False, past=4, future=3):
    return StabilizerConfig(
        past_frames=past, future_frames=future, working_height=120,
        frame_height=FH, frame_width=FW,
        gftt=GFTTConfig(max_features=256), lk=LKConfig(max_iters=20),
        ransac=RansacConfig(num_hypotheses=128),
        orb=ORBConfig(max_features=256, n_levels=3),
        sift=SIFTConfig(max_features=128),
        reference_compat=compat,
    )


@pytest.fixture(scope="module")
def footage():
    tex = make_default_texture(jax.random.key(0), size=256)
    traj = shake_trajectory(jax.random.key(5), 14, DEFAULT_APP_PARAMS,
                            pos_amplitude=0.004, roll_amplitude=0.3)
    return np.asarray(
        jax.vmap(lambda p: render_frame(tex, p, FH, FW))(traj)
    )


class TestQuirks:
    def test_q1_first_frame_unstabilized(self, footage):
        stab = Stabilizer(cfg_())
        out = np.asarray(stab.stabilize_frame(footage[0]))
        np.testing.assert_array_equal(out, footage[0])

    def test_q2_warmup_presents_oldest_frame(self, footage):
        """During warm-up (size <= future) the presentation frame is window
        index 0 (reference: src/stabilizer.cpp:1226-1229) — with near-zero
        motion the 2nd/3rd outputs re-present (a warp of) frame 0."""
        stab = Stabilizer(cfg_(future=3))
        stab.stabilize_frame(footage[0])
        out2 = np.asarray(stab.stabilize_frame(footage[1])).astype(np.float32)
        # output 2 must be closer to frame 0 than to frame 1's raw content
        d0 = np.abs(out2[40:-40, 40:-40] - footage[0][40:-40, 40:-40]).mean()
        d1 = np.abs(out2[40:-40, 40:-40] - footage[1][40:-40, 40:-40]).mean()
        assert d0 <= d1 + 1.0

    def test_q4_translation_rotation_locks_noop_in_compat(self, footage):
        """Compat mode: TRANSLATION/ROTATION locks must be no-ops (H identity
        -> output == presentation frame), reference src/stabilizer.cpp:790."""
        for mode in (StabilizationMode.TRANSLATION_LOCK,
                     StabilizationMode.ROTATION_LOCK):
            stab = Stabilizer(cfg_(compat=True), mode)
            outs = [np.asarray(stab.stabilize_frame(f)) for f in footage[:8]]
            # post warm-up output n presents frame n-future unwarped
            np.testing.assert_allclose(
                outs[7].astype(np.float32),
                footage[7 - 3].astype(np.float32), atol=1.0,
            )

    def test_q4_fixed_mode_locks_are_not_noop(self):
        # a camera rolling 0.5 deg per frame: the rotation to cancel is real,
        # not estimation noise on sub-0.1-degree shake
        tex = make_default_texture(jax.random.key(0), size=256)
        footage = np.stack([
            np.asarray(render_frame(
                tex, roll_clockwise(DEFAULT_APP_PARAMS, 0.25 * i), FH, FW))
            for i in range(10)])
        stab = Stabilizer(cfg_(compat=False), StabilizationMode.ROTATION_LOCK)
        outs = [np.asarray(stab.stabilize_frame(f)) for f in footage[:10]]
        diffs = [
            np.abs(outs[i].astype(np.float32)
                   - footage[i - 3].astype(np.float32)).mean()
            for i in range(6, 10)
        ]
        assert max(diffs) > 0.5  # rotation is actually being cancelled

    def test_q6_border_fill_half_mean(self, footage):
        """Warp border fill = 0.5 x mean presentation color
        (reference: src/stabilizer.cpp:1309-1313)."""
        stab = Stabilizer(cfg_(), StabilizationMode.ACCUMULATED_FULL_LOCK)
        # feed a shifted sequence so the lock forces a visible border
        shifted = [footage[0]]
        for i in range(1, 8):
            s = np.zeros_like(footage[0])
            s[:, 4 * i:] = footage[0][:, : FW - 4 * i]
            shifted.append(s)
        for f in shifted:
            out = np.asarray(stab.stabilize_frame(f))
        pres = shifted[8 - 3 - 1]
        expected = 0.5 * pres.reshape(-1, 3).astype(np.float64).mean(axis=0)
        border_px = out[FH // 2, -2].astype(np.float64)
        assert np.abs(border_px - expected).mean() < 3.0

    def test_q8_frame_size_change_rejected(self, footage):
        stab = Stabilizer(cfg_())
        stab.stabilize_frame(footage[0])
        with pytest.raises(Exception):
            stab.stabilize_frame(np.zeros((100, 100, 3), np.uint8))

    def test_compat_vs_fixed_smoothing_differ(self, footage):
        """The three smoothing quirks must actually change the output."""
        sc = Stabilizer(cfg_(compat=True))
        sf = Stabilizer(cfg_(compat=False))
        dc = df = 0.0
        for f in footage[:10]:
            oc = np.asarray(sc.stabilize_frame(f)).astype(np.float32)
            of = np.asarray(sf.stabilize_frame(f)).astype(np.float32)
            df += np.abs(oc - of).mean()
        assert df > 0.0  # quirk replication is not a no-op
