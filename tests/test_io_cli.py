"""IO layer + CLI argument tests."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.cli.args import parse_args
from video_stabilization.io import SimulatorSource, VideoWriter
from video_stabilization.io.native import (
    NativeFrameRing,
    NativeY4MReader,
    PrefetchingFileSource,
)


class TestArgs:
    def test_requires_exactly_one_source(self, capsys):
        with pytest.raises(SystemExit):
            parse_args([])
        with pytest.raises(SystemExit):
            parse_args(["--simulator", "--camera", "0"])

    def test_simulator_defaults(self):
        cfg = parse_args(["--simulator"])
        assert cfg.input_mode == "simulator"
        assert cfg.past_window_secs == 2.0
        assert cfg.future_window_secs == 1.5
        assert cfg.working_height == 360

    def test_file_mode(self):
        cfg = parse_args(["--file", "/tmp/x.mp4", "--working-height", "720"])
        assert cfg.input_mode == "file"
        assert cfg.file_path == "/tmp/x.mp4"
        assert cfg.working_height == 720

    def test_window_constraint(self):
        # total window below 0.030 s is rejected (reference:
        # src/main_utils.cpp:10, :209-216)
        with pytest.raises(SystemExit):
            parse_args(["--simulator", "--past-window", "0.0",
                        "--future-window", "0.0"])

    def test_height_constraint(self):
        with pytest.raises(SystemExit):
            parse_args(["--simulator", "--working-height", "90"])
        with pytest.raises(SystemExit):
            parse_args(["--simulator", "--working-height", "2161"])

    def test_negative_window_rejected(self):
        with pytest.raises(SystemExit):
            parse_args(["--simulator", "--past-window", "-1"])


class TestSimulatorSource:
    def test_render_and_move(self):
        src = SimulatorSource(frame_size=(120, 160))
        f0 = src.read()
        assert f0.shape == (120, 160, 3) and f0.dtype == np.uint8
        src.move("d")      # move right
        f1 = src.read()
        assert not np.array_equal(f0, f1)
        src.move("p")      # reset pose
        f2 = src.read()
        np.testing.assert_array_equal(f0, f2)

    def test_pose_text(self):
        src = SimulatorSource(frame_size=(60, 80))
        lines = src.pose_text()
        assert len(lines) == 2 and "pos" in lines[0]


class TestNative:
    def test_ring_fifo_order(self):
        ring = NativeFrameRing(4, (4, 4, 3))
        frames = [np.full((4, 4, 3), i, np.uint8) for i in range(4)]
        for f in frames:
            assert ring.push(f)
        for f in frames:
            np.testing.assert_array_equal(ring.pop(), f)
        ring.close()
        assert ring.pop(timeout_ms=50) is None

    def test_ring_blocking_timeout(self):
        ring = NativeFrameRing(1, (2, 2, 3))
        assert ring.push(np.zeros((2, 2, 3), np.uint8))
        # full: push times out
        assert not ring.push(np.zeros((2, 2, 3), np.uint8), timeout_ms=50)

    def test_y4m_roundtrip(self, tmp_path):
        path = str(tmp_path / "clip.y4m")
        w = VideoWriter(path, 30, (16, 24))
        frames = [
            np.random.default_rng(i).integers(0, 255, (16, 24, 3)).astype(np.uint8)
            for i in range(3)
        ]
        for f in frames:
            w.write(f)
        w.close()

        r = NativeY4MReader(path)
        assert r.frame_size == (16, 24)
        for f in frames:
            got = r.read()
            assert np.abs(got.astype(int) - f.astype(int)).mean() < 4.0
        assert r.read() is None
        r.close()

    @pytest.mark.parametrize("subsampling", ["444", "420"])
    def test_yuv_raw_planes_device_conversion(self, tmp_path, subsampling):
        """read_yuv + on-device yuv_flat_to_bgr must match the native
        reader's own host-side BGR conversion (same BT.601 constants and
        rounding, native/framebuf.cpp y4m_read_bgr)."""
        from video_stabilization.ops.image import yuv_flat_to_bgr

        path = str(tmp_path / "clip.y4m")
        w = VideoWriter(path, 30, (16, 24), subsampling=subsampling)
        frames = [
            np.random.default_rng(i).integers(0, 255, (16, 24, 3)).astype(np.uint8)
            for i in range(2)
        ]
        for f in frames:
            w.write(f)
        w.close()

        r_bgr = NativeY4MReader(path)
        r_yuv = NativeY4MReader(path)
        assert r_yuv.is_c420 == (subsampling == "420")
        for _ in frames:
            host = r_bgr.read()
            raw = r_yuv.read_yuv()
            assert raw is not None and raw.shape == (r_yuv.yuv_bytes,)
            dev = np.asarray(yuv_flat_to_bgr(
                jnp.asarray(raw), 16, 24, r_yuv.is_c420))
            np.testing.assert_allclose(
                dev.astype(int), host.astype(int), atol=1)
        assert r_yuv.read_yuv() is None
        r_bgr.close()
        r_yuv.close()

    def test_prefetching_yuv_source(self, tmp_path):
        from video_stabilization.io.native import PrefetchingYUVSource

        path = str(tmp_path / "clip.y4m")
        w = VideoWriter(path, 30, (12, 16), subsampling="420")
        for i in range(5):
            w.write(np.full((12, 16, 3), i * 10, np.uint8))
        w.close()

        src = PrefetchingYUVSource(NativeY4MReader(path), depth=3)
        assert src.is_c420
        got = []
        while True:
            f = src.read()
            if f is None:
                break
            got.append(f)
        assert len(got) == 5
        assert all(g.shape == (12 * 16 * 3 // 2,) for g in got)
        src.close()

    def test_prefetching_source(self, tmp_path):
        path = str(tmp_path / "clip.y4m")
        w = VideoWriter(path, 30, (12, 16))
        frames = [np.full((12, 16, 3), i * 10, np.uint8) for i in range(6)]
        for f in frames:
            w.write(f)
        w.close()

        src = PrefetchingFileSource(NativeY4MReader(path), depth=3)
        got = []
        while True:
            f = src.read()
            if f is None:
                break
            got.append(f)
        assert len(got) == 6
        src.close()


class TestHeadlessApp:
    def test_simulator_headless_run(self, tmp_path):
        from video_stabilization.cli.app import run
        from video_stabilization.cli.args import AppConfig

        out = str(tmp_path / "out.y4m")
        cfg = AppConfig(
            input_mode="simulator", past_window_secs=0.2,
            future_window_secs=0.1, working_height=180,
            output=out, max_frames=12, display=False,
        )
        assert run(cfg) == 0
        assert os.path.exists(out)
        r = NativeY4MReader(out)
        count = 0
        while r.read() is not None:
            count += 1
        # 12 frames, future window 3 -> first 3 buffered, 9 written
        assert count >= 6

    def test_checkpoint_resume_roundtrip(self, tmp_path):
        """--checkpoint saves the carry at exit; --resume restores it
        (engine/checkpoint.py wired through the CLI)."""
        from video_stabilization.cli.app import run
        from video_stabilization.cli.args import AppConfig

        ckpt = str(tmp_path / "state.npz")
        base = dict(
            input_mode="simulator", past_window_secs=0.2,
            future_window_secs=0.1, working_height=180,
            max_frames=8, display=False,
        )
        assert run(AppConfig(**base, checkpoint=ckpt)) == 0
        assert os.path.exists(ckpt)

        # resuming continues the frame counter instead of restarting
        import numpy as np

        data = np.load(ckpt)
        assert run(AppConfig(**base, resume=ckpt, checkpoint=ckpt)) == 0
        data2 = np.load(ckpt)
        # the frame-counter leaf must have advanced to 16
        counters = [int(data2[k]) for k in data2.files
                    if k != "__meta__" and data2[k].shape == ()
                    and data2[k].dtype == np.int32]
        assert 16 in counters

    def test_trail_mode_headless(self, tmp_path):
        from video_stabilization.cli.app import run
        from video_stabilization.cli.args import AppConfig

        out = str(tmp_path / "trail.y4m")
        cfg = AppConfig(
            input_mode="simulator", past_window_secs=0.2,
            future_window_secs=0.1, working_height=180,
            output=out, max_frames=8, display=False, trail=True,
        )
        assert run(cfg) == 0
        r = NativeY4MReader(out)
        frames = []
        while True:
            f = r.read()
            if f is None:
                break
            frames.append(f)
        assert len(frames) >= 3
        assert frames[-1].max() > 0      # composited content, not black

    def test_motion_model_flag(self):
        from video_stabilization.cli.args import parse_args

        cfg = parse_args(["--simulator", "--motion-model", "affine"])
        assert cfg.motion_model == "affine"

    def test_affine_motion_model_runs(self):
        from video_stabilization.cli.app import run
        from video_stabilization.cli.args import AppConfig

        cfg = AppConfig(
            input_mode="simulator", past_window_secs=0.2,
            future_window_secs=0.1, working_height=180,
            max_frames=6, display=False, motion_model="affine",
        )
        assert run(cfg) == 0

    def test_stats_flag_headless(self, capsys):
        """--stats prints the printTimings-style kernel categories at startup
        and per-second fps/step/inlier lines (reference:
        src/stabilizer.cpp:982-1009, 667-702)."""
        from video_stabilization.cli.app import run
        from video_stabilization.cli.args import AppConfig

        cfg = AppConfig(
            input_mode="simulator", past_window_secs=0.2,
            future_window_secs=0.1, working_height=180,
            max_frames=6, display=False, stats=True,
        )
        assert run(cfg) == 0
        out = capsys.readouterr().out
        assert "goodFeaturesToTrack" in out
        assert "calcOpticalFlowPyrLK" in out
        assert "warpPerspective" in out


class TestTerminalDisplay:
    def test_render_ansi_shape_and_colors(self):
        """The OpenCV-free preview (cli/term_display.py): half-block ANSI
        rendering — 2 pixels per text row, 24-bit colors, title row."""
        from video_stabilization.cli.term_display import render_ansi

        img = np.zeros((64, 96, 3), np.uint8)
        img[:, :48] = (255, 0, 0)                       # left half blue (BGR)
        s = render_ansi(img, max_cols=48, max_rows=17, title="t")
        lines = s.split("\n")
        assert lines[0].startswith("\x1b[0mt")
        body = lines[1:]
        assert 2 <= len(body) <= 16
        assert all("▀" in ln for ln in body)
        # left half renders pure blue -> RGB (0,0,255) fg escape present
        assert "38;2;0;0;255" in body[0]

    def test_side_by_side_and_no_tty_fallback(self):
        from video_stabilization.cli.term_display import (
            TerminalDisplay, render_side_by_side,
        )

        img = np.full((32, 32, 3), 128, np.uint8)
        s = render_side_by_side([("a", img), ("b", img)], 100, 20)
        assert s.startswith("\x1b[H")
        # without a TTY the display degrades gracefully: keys poll as None
        import io

        d = TerminalDisplay(out=io.StringIO())
        assert d.poll_key() is None
        d.close()
