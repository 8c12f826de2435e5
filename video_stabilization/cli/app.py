"""The interactive / headless application loop.

Mirrors the reference's main loop (src/main.cpp:185-260 +
src/main_utils.cpp): input-source factory, window sizing from
window-seconds x fps, keyboard mode switching, simulator movement keys, the
display sync buffer that delays the original feed by ``future_frames`` so
both windows are temporally aligned (src/main_utils.cpp:459-493), FPS and
camera-pose overlays, and "Buffering frames: k/n" warm-up messages.

Additions: headless operation (--no-display/--output/--max-frames), which
the GUI-only reference cannot do.
"""

from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np

from video_stabilization.cli.args import AppConfig, MODE_NAMES, parse_args
from video_stabilization.config import StabilizationMode, StabilizerConfig
from video_stabilization.io import SimulatorSource, VideoWriter, open_source
from video_stabilization.utils.timing import StageTimer

# keyboard -> mode (reference: handleStabilizationControls,
# src/main_utils.cpp:371-395)
MODE_KEYS = {
    "x": StabilizationMode.GLOBAL_SMOOTHING,
    "f": StabilizationMode.ACCUMULATED_FULL_LOCK,
    "o": StabilizationMode.ORB_FULL_LOCK,
    "l": StabilizationMode.SIFT_FULL_LOCK,
    "t": StabilizationMode.TRANSLATION_LOCK,
    "r": StabilizationMode.ROTATION_LOCK,
    "g": StabilizationMode.GLOBAL_SMOOTHING,
}
SIM_KEYS = "wsadqec p"


def _put_text(img, lines, origin=(8, 20)):
    try:
        import cv2
    except Exception:
        return img
    x, y = origin
    for line in lines:
        size, _ = cv2.getTextSize(line, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (x - 2, y - size[1] - 4), (x + size[0] + 2, y + 4),
                      (0, 0, 0), -1)
        cv2.putText(img, line, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1, cv2.LINE_AA)
        y += size[1] + 10
    return img


def _print_stage_timings(engine_cfg) -> None:
    """One-shot per-stage kernel timings in the reference's printTimings
    categories (GFTT / LK / motion fit / warp, src/stabilizer.cpp:982-1009),
    measured standalone, each closed by ``block_until_ready``."""
    import jax
    import jax.numpy as jnp

    from video_stabilization.motion.ransac import estimate_similarity_ransac
    from video_stabilization.ops.gftt import good_features_to_track
    from video_stabilization.ops.lk import lk_track
    from video_stabilization.ops.warp import warp_affine
    from video_stabilization.ops.pyramid import build_pyramid
    from video_stabilization.utils.timing import honest_time

    wh, ww = engine_cfg.working_size
    key = jax.random.key(0)
    gray = jax.random.uniform(key, (wh, ww), jnp.float32) * 255
    pyr_fn = jax.jit(lambda g: build_pyramid(g, engine_cfg.lk.pyramid_levels))
    pyr = pyr_fn(gray)
    pyr2 = pyr_fn(gray + 1.0)
    corners_fn = jax.jit(lambda g: good_features_to_track(g, engine_cfg.gftt))
    c = corners_fn(gray)
    lk_fn = jax.jit(lambda a, b, p, m: lk_track(a, b, p, m, engine_cfg.lk))
    tr = lk_fn(pyr, pyr2, c.points, c.mask)
    fit_fn = jax.jit(
        lambda a, b, m, k: estimate_similarity_ransac(a, b, m, k, engine_cfg.ransac)
    )
    frame = jax.random.uniform(
        key, (engine_cfg.frame_height, engine_cfg.frame_width, 3), jnp.float32
    )
    warp_fn = jax.jit(lambda f, h: warp_affine(f, h, 127.0))

    print("[stats] standalone kernel timings (ms):")
    for name, fn, xs in (
        ("goodFeaturesToTrack", corners_fn, (gray,)),
        ("calcOpticalFlowPyrLK", lk_fn, (pyr, pyr2, c.points, c.mask)),
        ("estimateAffinePartial2D", fit_fn,
         (c.points, tr.points, tr.status, jax.random.key(1))),
        ("warpPerspective", warp_fn, (frame, jnp.eye(3) + 1e-3)),
    ):
        print(f"[stats]   {name:24s} {honest_time(fn, *xs, iters=10):7.2f}")


def main(argv=None) -> int:
    cfg = parse_args(argv)
    return run(cfg)


def run(cfg: AppConfig) -> int:
    import jax

    from video_stabilization.engine import Stabilizer
    from video_stabilization.utils.timing import enable_compile_cache

    enable_compile_cache()

    source = open_source(
        cfg.input_mode, path=cfg.file_path, camera_id=cfg.camera_id,
        texture=cfg.texture,
    )
    fps = source.fps
    fh, fw = source.frame_size

    # window sizing: frames = seconds x fps (reference: src/main.cpp:205-207)
    past = max(0, int(round(cfg.past_window_secs * fps)))
    future = max(0, int(round(cfg.future_window_secs * fps)))
    if past == 0 and future == 0:
        past = 1

    from video_stabilization.config import RansacConfig

    engine_cfg = StabilizerConfig(
        past_frames=past, future_frames=future,
        working_height=cfg.working_height,
        frame_height=fh, frame_width=fw,
        reference_compat=cfg.reference_compat,
        ransac=RansacConfig(motion_model=cfg.motion_model),
    )
    mode = StabilizationMode[MODE_NAMES[cfg.mode]]
    stab = Stabilizer(engine_cfg, mode)

    if cfg.resume:
        from video_stabilization.engine.checkpoint import load_carry

        stab.carry = load_carry(cfg.resume, stab.carry)
        print(f"[app] resumed engine state from {cfg.resume} "
              f"(frame counter {int(stab.carry.n)})")

    if cfg.stats:
        _print_stage_timings(engine_cfg)

    print(f"[app] source: {cfg.input_mode} {fw}x{fh} @ {fps:.1f} fps")
    print(f"[app] window: past={past} future={future} frames "
          f"(delay {future / fps:.2f}s), working height {cfg.working_height}")
    print("[app] controls: X/G smoothing | F accumulated lock | O ORB lock | "
          "L SIFT lock | T translation lock | R rotation lock | ESC quit")
    if cfg.input_mode == "simulator":
        print("[app] simulator: W/S/A/D move, Q/E roll, SPACE/C up/down, P reset")

    writer = None
    if cfg.output:
        writer = VideoWriter(cfg.output, fps, (fh, fw))

    # --- preview backend selection ------------------------------------------
    # "cv2": HighGUI windows (parity with the reference,
    # src/main_utils.cpp:300-325).  "term": ANSI truecolor half-blocks +
    # raw-mode key polling (cli/term_display.py) — zero OpenCV, zero X —
    # completing the no-cv2 story the native Y4M reader started.
    backend = None
    term_disp = None
    if cfg.display:
        want = cfg.display_backend
        has_x = bool(os.environ.get("DISPLAY")) or sys.platform == "darwin"
        if want in ("auto", "cv2") and has_x:
            # cv2's Qt backend abort()s (uncatchable) without an X server;
            # only try when one is reachable
            try:
                import cv2
                cv2.namedWindow("Original Camera Feed", cv2.WINDOW_NORMAL)
                cv2.namedWindow("Stabilized Output", cv2.WINDOW_NORMAL)
                backend = "cv2"
            except Exception as e:
                print(f"[app] cv2 display unavailable ({e})", file=sys.stderr)
        elif want == "cv2" and not has_x:
            print("[app] no $DISPLAY; running headless", file=sys.stderr)
        if backend is None and want in ("auto", "term"):
            from video_stabilization.cli.term_display import TerminalDisplay

            if want == "term" or TerminalDisplay._is_tty():
                term_disp = TerminalDisplay()
                backend = "term"
        if backend is None and want == "auto":
            print("[app] no display available; running headless",
                  file=sys.stderr)
    display = backend is not None

    # display sync buffer: delay originals so both views align
    # (reference: src/main_utils.cpp:459-493)
    original_buffer: collections.deque = collections.deque()
    timer = StageTimer()
    n = 0
    trail_bg = None
    trail_fn = None
    stats_last = time.perf_counter()
    stage_report_line = None
    stage_report_at = 0.0
    t_prev = time.perf_counter()

    def _refresh_stage_report(frame):
        """In-loop per-stage device times of the fused step (printTimings
        parity, reference src/stabilizer.cpp:982-1009): trace a few live
        steps on a COPY of the carry (so the profile doesn't advance engine
        state) and aggregate device time by the stage_* named scopes."""
        import jax
        import jax.numpy as jnp

        from video_stabilization.utils.stage_profile import (
            format_stage_report, profile_stages,
        )

        try:
            fj = jnp.asarray(frame)
            hlo = stab._step.lower(stab.carry, fj).compile().as_text()
            carry_copy = jax.tree.map(jnp.copy, stab.carry)
            n_prof = 4

            def run_steps():
                c = carry_copy
                out = None
                for _ in range(n_prof):
                    c, (out, _v) = stab._step(c, fj)
                jax.block_until_ready(out)

            stage_ms = profile_stages(run_steps, hlo, n_calls=n_prof)
            if not stage_ms:
                return None
            return "[stats] in-loop stages: " + format_stage_report(stage_ms)
        except Exception as e:  # profiling is best-effort: report, never stop
            return f"[stats] in-loop stage profile unavailable: {e}"
    try:
        while True:
            if cfg.max_frames is not None and n >= cfg.max_frames:
                break

            key = None
            if backend == "cv2":
                import cv2
                k = cv2.waitKey(1) & 0xFF
                if k == 27:
                    break
                if k != 255:
                    key = chr(k).lower()
            elif backend == "term":
                k = term_disp.poll_key()
                if k == "\x1b":
                    break
                if k:
                    key = k.lower()

            if key is not None and key in MODE_KEYS:
                stab.set_stabilization_mode(MODE_KEYS[key])
                print(f"[app] mode -> {MODE_KEYS[key].name}")
            elif key is not None and key in SIM_KEYS and isinstance(source, SimulatorSource):
                source.move(key)

            frame = source.read()
            if frame is None:
                print("[app] end of stream")
                break

            out = stab.stabilize_frame(frame)
            if cfg.debug_features:
                # corners detected on THIS frame (carry.corners_prev), kept
                # alongside it in the sync buffer so the overlay drawn on the
                # delayed original matches the displayed image, not a frame
                # future_frames newer
                dbg = (np.asarray(stab.carry.corners_prev),
                       np.asarray(stab.carry.corners_mask))
            else:
                dbg = None
            original_buffer.append((frame, dbg))
            n += 1

            now = time.perf_counter()
            timer.record("frame", (now - t_prev) * 1000.0)
            t_prev = now

            if cfg.stats and (time.perf_counter() - stats_last) >= 1.0:
                stats_last = time.perf_counter()
                avg_ms = timer.averages().get("frame", float("nan"))
                cur_mode = StabilizationMode(int(stab.carry.mode))
                line = (f"[stats] fps {1000.0 / max(avg_ms, 1e-3):6.1f} | "
                        f"step {avg_ms:6.1f} ms | "
                        f"RANSAC inliers {int(stab.carry.last_inliers):4d}")
                if cur_mode in (StabilizationMode.ORB_FULL_LOCK,
                                StabilizationMode.SIFT_FULL_LOCK):
                    # good-match telemetry of the registration lock
                    # (reference logs per frame, src/stabilizer.cpp:667-702)
                    line += (" | lock matches "
                             f"{int(stab.carry.last_lock_matches):4d}")
                print(line + f" | mode {cur_mode.name}")
                # per-stage breakdown of the fused step, re-sampled every
                # 10 s (tracing a few steps costs ~1 frame of work)
                if time.perf_counter() - stage_report_at > 10.0:
                    stage_report_line = _refresh_stage_report(frame)
                    stage_report_at = time.perf_counter()
                if stage_report_line:
                    print(stage_report_line)

            if len(original_buffer) <= future:
                print(f"Buffering frames: {len(original_buffer)}/{future + 1}")
                continue
            delayed, delayed_dbg = original_buffer.popleft()

            if cfg.trail:
                # feathered trail compositing (the reference's dormant
                # copyFeathered path, src/stabilizer.cpp:1051-1155): the
                # presentation frame is feather-blended over a fading
                # background with its stabilization transform.
                import jax.numpy as jnp

                from video_stabilization.ops.compositing import copy_feathered

                if trail_bg is None:
                    trail_bg = jnp.zeros((fh, fw, 3), jnp.float32)
                    trail_fn = jax.jit(copy_feathered)
                h_full = np.asarray(stab.carry.last_h).copy()
                h_full[:2, 2] /= engine_cfg.scale_factor
                trail_bg = trail_fn(
                    jnp.asarray(delayed, jnp.float32), trail_bg,
                    jnp.asarray(h_full, jnp.float32),
                )
                out_np = np.clip(np.asarray(trail_bg), 0, 255).astype(np.uint8)
            else:
                out_np = np.asarray(out)
            if writer is not None:
                writer.write(out_np)

            if display:
                fps_now = 1000.0 / max(timer.averages().get("frame", 1.0), 1e-3)
                overlay = [f"FPS: {fps_now:.1f}"]
                if isinstance(source, SimulatorSource):
                    overlay += source.pose_text()
                if backend == "cv2":
                    import cv2
                    disp = _put_text(delayed.copy(), overlay)
                else:
                    disp = delayed.copy()
                if cfg.debug_features and delayed_dbg is not None:
                    # tracked-corner overlay (the reference's "features"
                    # debug window, src/stabilizer.cpp:628-634), from the
                    # corner set buffered with this delayed frame
                    pts, msk = delayed_dbg
                    inv_s = 1.0 / engine_cfg.scale_factor
                    for x, y in pts[msk][:400]:
                        px, py = int(x * inv_s), int(y * inv_s)
                        if backend == "cv2":
                            cv2.circle(disp, (px, py), 3, (0, 255, 0), 1)
                        else:
                            disp[max(0, py - 1):py + 2,
                                 max(0, px - 1):px + 2] = (0, 255, 0)
                if backend == "cv2":
                    cv2.imshow("Original Camera Feed", disp)
                    cv2.imshow("Stabilized Output", out_np)
                else:
                    term_disp.show([
                        (" | ".join(overlay) + "  [original]", disp),
                        (f"mode {StabilizationMode(int(stab.carry.mode)).name}"
                         "  [stabilized]", out_np),
                    ])
    finally:
        source.close()
        if writer is not None:
            writer.close()
        if cfg.checkpoint:
            from video_stabilization.engine.checkpoint import save_carry

            save_carry(cfg.checkpoint, stab.carry)
            print(f"[app] saved engine state to {cfg.checkpoint}")
        if backend == "cv2":
            try:
                import cv2
                cv2.destroyAllWindows()
            except Exception:
                pass
        elif backend == "term":
            term_disp.close()

    avg = timer.averages().get("frame", float("nan"))
    print(f"[app] processed {n} frames, avg {avg:.1f} ms/frame")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
