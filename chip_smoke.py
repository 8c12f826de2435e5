#!/usr/bin/env python
"""Smoke check of the stabilizer on one NVIDIA GPU.

Drives the main path once at the reference's documented default deployment
(1080p30 frames, working height 360, a 2.0 s past / 1.5 s future window,
GFTT 1280, 4-level dense LK, 256 RANSAC hypotheses) through the entry
points a user calls, and checks every result against a plain reference:

  1. kernels at real widths: the output warp at 1080p x 3 against a float64
     bilinear reference and the analytic sampling map; FAST at every level
     of the 360x640 ORB pyramid against a brute-force segment test; each
     op's device time beside its bytes floor
  2. streaming smoothing through ``Stabilizer`` and ``make_scan_fn``, 150
     simulator frames; corner drift against the analytic truth
  3. lock modes through ``make_offline_batched_fn``: ORB lock at 720p, SIFT
     lock + ECC at 1080p, accumulated lock with one stream pre-rotated by
     25 degrees; drift against the analytic truth
  4. serving: ``serve.serve_files`` on 4 simulator Y4M streams at 1080p
  5. per-stage device time of the phase-2 step from a profiler trace

Usage:

  python chip_smoke.py          # one GPU, phases 1-5
  python chip_smoke.py --four   # four GPUs: sharded serving vs one card

Every phase raises on failure, so the process then exits non-zero without
the last line.  The last stdout line is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.  It exits non-zero at
once when the package is missing or JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Corner drift (working-res px) of the phase-2 program against the analytic
# truth, measured with the same program on the same footage on the CPU
# backend (JAX 0.9.0); the GPU may differ by TF32 matrix products and
# reduction order, for which the margin allows 5%.
STREAM_DRIFT_CPU_PX = 0.99236
STREAM_DRIFT_MARGIN_PX = 0.05
# Lock drift bound (working-res px): the engine fits rigid motions, the
# simulator's truth keeps the small scale and perspective of the shaking
# camera, so a correct lock sits within a few px; a wrong one is tens off.
LOCK_DRIFT_BOUND_PX = 3.0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(AssertionError):
    """A phase's result disagrees with its reference."""


def check(ok, what) -> None:
    """Raise CheckFailed unless ``ok`` (an explicit raise: ``assert``
    statements vanish under ``python -O``)."""
    if not ok:
        raise CheckFailed(what)


class Timer:
    """Splits a phase into compile (first call of each program, one run
    included) and run seconds."""

    def __init__(self, name: str):
        self.name = name
        self.compile_s = 0.0
        self.t0 = time.perf_counter()

    def first_call(self, fn, *args):
        import jax

        t = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        self.compile_s += time.perf_counter() - t
        return out

    def done(self) -> None:
        total = time.perf_counter() - self.t0
        log(f"[{self.name}] compile {self.compile_s:.1f} s (first calls), "
            f"run {total - self.compile_s:.1f} s")


def render_clip(n_frames, h, w, stream=0):
    """Simulator footage on device, (T, H, W, 3) u8, plus its trajectory."""
    import jax
    import jax.numpy as jnp

    from video_stabilization.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame,
        shake_trajectory,
    )

    tex = make_default_texture(jax.random.key(0), size=512)
    render = jax.jit(lambda t, p: render_frame(t, p, h, w))
    traj = shake_trajectory(jax.random.key(5 + stream), n_frames,
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004,
                            roll_amplitude=0.3)
    frames = jnp.stack([render(tex, jax.tree.map(lambda x: x[i], traj))
                        for i in range(n_frames)])
    return jax.block_until_ready(frames), traj


def _rigid(theta_deg, tx, ty, center=(0.0, 0.0)):
    t = np.deg2rad(theta_deg)
    r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    m = np.eye(3)
    m[:2, :2] = r
    c = np.asarray(center, float)
    m[:2, 2] = c - r @ c + (tx, ty)
    return m.astype(np.float32)


def _device_ms(fn, *args, n=20):
    from video_stabilization.utils.stage_profile import device_ms_per_call

    def run():
        out = None
        for _ in range(n):
            out = fn(*args)
        import jax

        jax.block_until_ready(out)

    return device_ms_per_call(run, n)


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


# ---------------------------------------------------------------- phase 1
def phase_kernels(h=1080, w=1920, pyr_h=360, pyr_w=640, edge=31):
    import jax
    import jax.numpy as jnp

    from video_stabilization.ops.fast import fast_score
    from video_stabilization.ops.reference import (
        fast_score_reference, warp_bilinear_reference,
    )
    from video_stabilization.ops.warp import warp_affine, warp_perspective

    tm = Timer("phase 1 kernels")
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    nat = 127.0 + 80.0 * np.sin(xs / 23.0) * np.cos(ys / 17.0)
    frame = np.stack([nat, nat[::-1], nat[:, ::-1]], -1).astype(np.uint8)
    frame_f = jnp.asarray(frame, jnp.float32)
    border = np.array([10.0, 20.0, 30.0], np.float32)
    center = (w / 2.0, h / 2.0)
    cases = {
        "rigid +0.4deg": _rigid(0.4, 3.2, -1.7, center),
        "rigid -0.8deg": _rigid(-0.8, -5.5, 2.25, center),
        "rigid +1.5deg": _rigid(1.5, 0.6, 4.1, center),
        "rotation 25deg": _rigid(25.0, 0.0, 0.0, center),
        "projective": np.array([[1.01, 0.02, -8.0], [-0.015, 0.99, 5.0],
                                [2e-5, -1e-5, 1.0]], np.float32),
    }
    aff = jax.jit(lambda f, m, c: warp_affine(f, m, c))
    per = jax.jit(lambda f, m, c: warp_perspective(f, m, None, c))
    for name, m in cases.items():
        fn = per if name == "projective" else aff
        mj = jnp.asarray(m)
        out = np.asarray(tm.first_call(fn, frame_f, mj, jnp.asarray(border)))
        ref = warp_bilinear_reference(frame, m, border)
        err_val = float(np.abs(out - ref).max())
        # coordinate ramps: the output must be the analytic sampling map
        hinv = np.linalg.inv(m.astype(np.float64))
        den = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
        sx = (hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / den
        sy = (hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / den
        sel = (sx >= 1) & (sx <= w - 2) & (sy >= 1) & (sy <= h - 2)
        ox = np.asarray(fn(jnp.asarray(xs), mj, -1.0))
        oy = np.asarray(fn(jnp.asarray(ys), mj, -1.0))
        err_px = float(max(np.abs(ox - sx)[sel].max(),
                           np.abs(oy - sy)[sel].max()))
        log(f"  warp {name}: max |out - float64 ref| {err_val:.4f} gray, "
            f"sampling map max error {err_px:.5f} px")
        check(err_val <= 0.5, (name, err_val))
        check(err_px <= 2e-2, (name, err_px))

    warp_u8 = jax.jit(lambda f, m, c: jnp.clip(jnp.round(
        warp_affine(f.astype(jnp.float32), m, c)), 0, 255).astype(jnp.uint8))
    fr = jnp.asarray(frame)
    tm.first_call(warp_u8, fr, jnp.asarray(cases["rigid +0.4deg"]),
                  jnp.asarray(border))
    floor_ms = 2 * h * w * 3 / HBM_BYTES_PER_S * 1e3
    for name in ("rigid +0.4deg", "rotation 25deg"):
        ms = _device_ms(warp_u8, fr, jnp.asarray(cases[name]),
                        jnp.asarray(border))
        log(f"  warp u8 {h}x{w}x3 {name}: device {_fmt_ms(ms)}, bytes "
            f"floor {floor_ms * 1e3:.2f} us (u8 in + u8 out at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")

    # FAST at every level of the ORB pyramid (ops/orb.py level shapes)
    rng = np.random.default_rng(0)
    fast = jax.jit(lambda im: fast_score(im, 20.0)[0])
    total_ms = 0.0
    for level in range(12):
        s = 1.2 ** level
        lh, lw = int(round(pyr_h / s)), int(round(pyr_w / s))
        if lh <= 2 * edge or lw <= 2 * edge:
            break
        img = rng.integers(0, 255, (lh, lw)).astype(np.float32)
        got = np.asarray(tm.first_call(fast, jnp.asarray(img)))
        np.testing.assert_array_equal(got, fast_score_reference(img, 20.0),
                                      err_msg=f"FAST level {level}")
        ms = _device_ms(fast, jnp.asarray(img))
        total_ms += ms or 0.0
        floor = 8 * lh * lw / HBM_BYTES_PER_S * 1e3
        log(f"  FAST level {level} {lh}x{lw}: equal to brute force; device "
            f"{_fmt_ms(ms)}, bytes floor {floor * 1e3:.2f} us (f32 in + "
            f"f32 score out)")
    log(f"  FAST all levels: device {total_ms * 1e3:.1f} us per image")
    tm.done()


# ---------------------------------------------------------------- phase 2
def phase_streaming(h=1080, w=1920, n_frames=150, past=60, future=45,
                    working=360, n_scan=16, drift_bound=None):
    import jax
    import jax.numpy as jnp

    from video_stabilization.config import StabilizationMode, StabilizerConfig
    from video_stabilization.engine import Stabilizer, init_carry, make_scan_fn
    from video_stabilization.sim.truth import (
        analytic_smoothing_truth, corner_drift,
    )

    tm = Timer("phase 2 streaming smoothing")
    mode = StabilizationMode.GLOBAL_SMOOTHING
    cfg = StabilizerConfig(past_frames=past, future_frames=future,
                           working_height=working, frame_height=h,
                           frame_width=w, static_mode=int(mode))
    footage, traj = render_clip(n_frames, h, w)
    stab = Stabilizer(cfg, mode, seed=0)
    outs = [tm.first_call(stab.stabilize_frame, footage[0])]
    hs = [np.asarray(stab.carry.last_h, np.float64)]
    for i in range(1, n_frames):
        out = stab.stabilize_frame(footage[i])
        if i < n_scan:
            outs.append(out)
        hs.append(np.asarray(stab.carry.last_h, np.float64))
    check(np.isfinite(np.stack(hs)).all(), "non-finite transform")
    wh, ww = cfg.working_size
    qs = analytic_smoothing_truth(traj, n_frames, wh, ww, past, future)
    drift = corner_drift(hs, qs, ww, wh)
    log(f"  Stabilizer: {n_frames} frames of {w}x{h}, window {past}/"
        f"{future}; corner drift vs analytic truth {drift:.4f} px"
        + (f" (bound {drift_bound:.4f})" if drift_bound is not None else ""))
    if drift_bound is not None:
        check(drift <= drift_bound, (drift, drift_bound))

    scan = make_scan_fn(cfg)
    carry = init_carry(cfg, int(mode), jax.random.key(0))
    carry, (souts, valid) = tm.first_call(scan, carry, footage[:n_scan])
    a = np.asarray(souts).astype(np.int16)
    b = np.stack([np.asarray(o) for o in outs]).astype(np.int16)
    diff = np.abs(a - b)
    log(f"  make_scan_fn: {n_scan} frames, max |scan - Stabilizer| "
        f"{int(diff.max())} gray, {float((diff > 0).mean()):.2e} of values "
        f"differ")
    check(bool(np.asarray(valid).all()) and a.shape == (n_scan, h, w, 3),
          ("scan outputs", a.shape))
    # two compiled programs (scan body vs step): float rounding may differ
    check(diff.max() <= 1 and (diff > 0).mean() <= 0.02, "scan vs Stabilizer")
    tm.done()
    return stab, footage[n_frames - 1], drift


# ---------------------------------------------------------------- phase 3
def _run_offline(cfg, mode, clips, chunk, timer, key=0, after_chunk=None):
    """clips: (S, T, H, W, 3) u8 device array.  Returns (outputs (S, T, ...)
    numpy, chunk-end last_h per stream (n_chunks, S, 3, 3), final carry)."""
    import jax

    from video_stabilization.engine import make_offline_batched_fn
    from video_stabilization.parallel import init_batched_carry

    fn = make_offline_batched_fn(cfg)
    s, t = clips.shape[:2]
    carry = init_batched_carry(cfg, s, int(mode), jax.random.key(key))
    carry = carry._replace(key=jax.numpy.broadcast_to(carry.key[0], (s,)))
    outs, hs = [], []
    for i in range(0, t, chunk):
        args = (carry, clips[:, i:i + chunk])
        if i == 0:
            carry, (out, valid) = timer.first_call(fn, *args)
        else:
            carry, (out, valid) = fn(*args)
        check(bool(np.asarray(valid).all()), "invalid output frame")
        outs.append(np.asarray(out))
        hs.append(np.asarray(carry.last_h, np.float64))
        if after_chunk is not None:
            carry = after_chunk(i // chunk, carry)
    return np.concatenate(outs, 1), np.stack(hs), carry


def _lock_drift(hs_chunks, traj, n_frames, chunk, cfg):
    from video_stabilization.sim.truth import analytic_lock_truth, corner_drift

    wh, ww = cfg.working_size
    truth = analytic_lock_truth(traj, n_frames, wh, ww, cfg.future_frames)
    ends = [min(i + chunk, n_frames) for i in range(0, n_frames, chunk)]
    return corner_drift(list(hs_chunks), [truth[e - 1] for e in ends],
                        ww, wh, skip=0)


def phase_locks(sizes=((720, 1280), (1080, 1920)), n_frames=96, chunk=8,
                past=60, future=45, working=360):
    import jax.numpy as jnp

    from video_stabilization.config import (
        ECCConfig, StabilizationMode, StabilizerConfig,
    )
    from video_stabilization.ops.warp import warp_affine

    tm = Timer("phase 3 lock modes (offline batched)")

    def config(h, w, mode, ecc=False):
        return StabilizerConfig(past_frames=past, future_frames=future,
                                working_height=working, frame_height=h,
                                frame_width=w, static_mode=int(mode),
                                ecc=ECCConfig(enabled=ecc))

    (h_orb, w_orb), (h_big, w_big) = sizes
    # ORB lock at 720p, SIFT lock + ECC at 1080p
    for name, (h, w), mode, ecc in (
            ("ORB lock", (h_orb, w_orb), StabilizationMode.ORB_FULL_LOCK,
             False),
            ("SIFT lock + ECC", (h_big, w_big),
             StabilizationMode.SIFT_FULL_LOCK, True)):
        cfg = config(h, w, mode, ecc)
        clip, traj = render_clip(n_frames, h, w)
        outs, hs, carry = _run_offline(cfg, mode, clip[None], chunk, tm)
        matches = int(np.asarray(carry.last_lock_matches)[0])
        drift = _lock_drift(hs[:, 0], traj, n_frames, chunk, cfg)
        log(f"  {name} {w}x{h}: {n_frames} frames, last good matches "
            f"{matches}, corner drift vs analytic truth {drift:.4f} px "
            f"(bound {LOCK_DRIFT_BOUND_PX})")
        check(outs.shape == (1, n_frames, h, w, 3), (name, outs.shape))
        check(np.isfinite(hs).all() and matches >= cfg.ransac.min_points,
              (name, "matches", matches))
        check(drift <= LOCK_DRIFT_BOUND_PX, (name, drift))

    # accumulated lock, stream 1's carry pre-rotated by 25 degrees about the
    # working-res center after the first chunk
    h, w = h_big, w_big
    mode = StabilizationMode.ACCUMULATED_FULL_LOCK
    cfg = config(h, w, mode)
    wh, ww = cfg.working_size
    rot = _rigid(25.0, 0.0, 0.0, (ww / 2.0, wh / 2.0))
    clip, traj = render_clip(n_frames, h, w)

    def pre_rotate(j, carry):
        if j != 0:
            return carry
        accum = carry.accum_h.at[1].set(
            jnp.matmul(carry.accum_h[0], jnp.asarray(rot)))
        return carry._replace(accum_h=accum)

    outs, hs, carry = _run_offline(cfg, mode, jnp.stack([clip, clip]), chunk,
                                   tm, after_chunk=pre_rotate)
    blank = [(s, t) for s in range(2) for t in range(n_frames)
             if outs[s, t].std() < 5.0]
    check(not blank, f"blank output frames {blank[:5]}")
    # the rotated stream's lock is the plain one composed with inv(rot)
    want = np.linalg.inv(rot.astype(np.float64)) @ hs[-1, 0]
    err = float(np.abs(hs[-1, 1] - want).max())
    # its last frame equals the single-frame warp of the presentation frame
    pres = n_frames - future - 1
    m = hs[-1, 1].copy()
    m[0:2, 2] /= cfg.scale_factor
    frame = clip[pres].astype(jnp.float32)
    single = warp_affine(frame, jnp.asarray(m, jnp.float32),
                         0.5 * jnp.mean(frame, axis=(0, 1)))
    single = np.asarray(jnp.clip(jnp.round(single), 0, 255)).astype(np.int16)
    diff = np.abs(outs[1, -1].astype(np.int16) - single)
    drift = _lock_drift(hs[:, 0], traj, n_frames, chunk, cfg)
    log(f"  accumulated lock {w}x{h}: stream 1 pre-rotated 25 deg; |lock1 -"
        f" inv(R) lock0| {err:.2e}; last frame vs single-frame warp max "
        f"{int(diff.max())} gray ({float((diff > 0).mean()):.2e} differ); no "
        f"blank frame; stream 0 drift vs analytic truth {drift:.4f} px")
    check(err < 1e-3, err)
    check(diff.max() <= 1 and (diff > 0).mean() < 0.01,
          "rotated stream vs single-frame warp")
    check(drift <= LOCK_DRIFT_BOUND_PX, drift)
    tm.done()


# ---------------------------------------------------------------- phase 4
def phase_serving(h=1080, w=1920, n_streams=4, n_frames=64, chunk=8,
                  past=60, future=45, working=360):
    import jax
    import jax.numpy as jnp

    from video_stabilization import serve
    from video_stabilization.config import StabilizationMode
    from video_stabilization.io.native import NativeY4MReader
    from video_stabilization.io.video import VideoWriter
    from video_stabilization.ops.image import yuv_flat_to_bgr
    from video_stabilization.parallel import init_batched_carry
    from video_stabilization.parallel.streams import (
        make_sharded_offline_fn, make_stream_mesh, shard_carry,
    )
    from video_stabilization.sim import shake_trajectory, DEFAULT_APP_PARAMS
    from video_stabilization.sim.truth import (
        analytic_smoothing_truth, corner_drift,
    )

    tm = Timer("phase 4 serving (serve_files)")
    paths = serve._render_sim_streams(n_streams, n_frames, h, w, log=log)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    # serve_files compiles inside its own loop: its time counts as compile
    done, dt = tm.first_call(lambda: serve.serve_files(
        paths, out_dir, "smoothing", working_height=working, past=past,
        future=future, chunk=chunk, log=log))
    check(done == n_frames, done)
    served = []
    for p in paths:
        rd = NativeY4MReader(os.path.join(
            out_dir, f"stabilized_{os.path.basename(p)}"))
        frames = []
        while (f := rd.read()) is not None:
            frames.append(f)
        rd.close()
        check(len(frames) == n_frames and frames[0].shape == (h, w, 3),
              (p, len(frames)))
        served.append(frames)

    # stream 0 again, in memory through the same sharded program: equal
    # output (through one Y4M round trip, as the writer re-encodes chroma)
    # and its drift against the analytic truth
    mode = StabilizationMode.GLOBAL_SMOOTHING
    cfg = serve._serve_config(h, w, working, past, future, int(mode))
    devs = serve.pick_serving_devices(jax.devices(), n_streams, log=log)
    mesh = make_stream_mesh(devs)
    fn = make_sharded_offline_fn(cfg, mesh)
    to_bgr = jax.jit(lambda y: yuv_flat_to_bgr(y, h, w, True))
    readers = [NativeY4MReader(p) for p in paths]
    carry = shard_carry(init_batched_carry(cfg, n_streams, int(mode),
                                           jax.random.key(0)), mesh)
    hs, outs0 = [], []
    for i in range(0, n_frames, chunk):
        yuv = jnp.asarray(np.stack([r.read_yuv_block(chunk) for r in readers]))
        carry, (out, _) = fn(carry, to_bgr(yuv))
        hs.append(np.asarray(carry.last_h[0], np.float64))
        outs0.append(np.asarray(out[0]))
    for r in readers:
        r.close()
    outs0 = np.concatenate(outs0)
    rt = os.path.join(out_dir, "roundtrip.y4m")
    wr = VideoWriter(rt, 30.0, (h, w), subsampling="420")
    for f in outs0:
        wr.write(f)
    wr.close()
    rd = NativeY4MReader(rt)
    for i in range(n_frames):
        np.testing.assert_array_equal(served[0][i], rd.read(),
                                      err_msg=f"served frame {i}")
    rd.close()
    traj = shake_trajectory(jax.random.key(5), n_frames, DEFAULT_APP_PARAMS,
                            pos_amplitude=0.004, roll_amplitude=0.3)
    wh, ww = cfg.working_size
    qs = analytic_smoothing_truth(traj, n_frames, wh, ww, past, future)
    ends = range(chunk, n_frames + 1, chunk)
    drift = corner_drift(hs, [qs[e - 1] for e in ends], ww, wh, skip=0)
    log(f"  served {n_streams} x {n_frames} frames of {w}x{h} in {dt:.2f} s;"
        f" stream 0 equals the in-memory path; its drift vs analytic truth "
        f"{drift:.4f} px at chunk ends (bound {LOCK_DRIFT_BOUND_PX})")
    check(drift <= LOCK_DRIFT_BOUND_PX, drift)
    tm.done()


# ---------------------------------------------------------------- phase 5
def phase_stage_profile(stab, frame, n_calls=4):
    import jax
    import jax.numpy as jnp

    from video_stabilization.utils.stage_profile import (
        format_stage_report, profile_stages,
    )

    tm = Timer("phase 5 per-stage trace")
    t = time.perf_counter()
    hlo = stab._step.lower(stab.carry, frame).compile().as_text()
    tm.compile_s += time.perf_counter() - t
    def run_steps():
        # the step donates its carry: run on a copy, leave stab.carry as is
        c, out = jax.tree.map(jnp.copy, stab.carry), None
        jax.block_until_ready(c)
        for _ in range(n_calls):
            c, (out, _) = stab._step(c, frame)
        jax.block_until_ready(out)

    stage_ms = profile_stages(run_steps, hlo, n_calls=n_calls)
    log("  " + format_stage_report(stage_ms))
    log("  " + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
        stage_ms.items(), key=lambda kv: -kv[1])))
    for stage in ("stage_gray_pyramid", "stage_gftt", "stage_lk",
                  "stage_fit", "stage_warp"):
        ms = sum(v for k, v in stage_ms.items() if k.startswith(stage))
        check(ms > 0.0, (stage, stage_ms))
    parts = sum(v for k, v in stage_ms.items() if k != "total")
    check(abs(parts - stage_ms["total"]) <= 1e-6 * stage_ms["total"] + 1e-9,
          ("stages + other != total", parts, stage_ms["total"]))
    tm.done()


# ---------------------------------------------------------------- --four
def four_cards(devices, h=1080, w=1920, n_streams=8, n_frames=16, chunk=8,
               past=60, future=45, working=360):
    """serve.stabilize_streams_sharded over the given devices against
    make_offline_batched_fn on one device, per stream."""
    import jax
    import jax.numpy as jnp

    from video_stabilization import serve
    from video_stabilization.config import StabilizationMode
    from video_stabilization.engine import make_offline_batched_fn
    from video_stabilization.parallel import init_batched_carry
    from video_stabilization.parallel.streams import (
        make_sharded_offline_fn, make_stream_mesh, shard_carry,
    )

    tm = Timer(f"--four sharded serving over {len(devices)} devices")
    devs = serve.pick_serving_devices(devices, n_streams, log=log)
    check(len(devs) == len(devices), devs)
    mesh = make_stream_mesh(devs)
    per_dev = n_streams // len(devs)
    clips = jnp.stack([render_clip(n_frames, h, w, stream=s)[0]
                       for s in range(n_streams)])        # (S, T, H, W, 3)
    modes = (StabilizationMode.GLOBAL_SMOOTHING,
             StabilizationMode.ACCUMULATED_FULL_LOCK)
    key = jax.random.key(3)

    # compile the four programs at once (XLA compiles outside the GIL); the
    # calls below then load them from the persistent compilation cache
    t = time.perf_counter()
    lowered = []
    for mode in modes:
        cfg = serve._serve_config(h, w, working, past, future, int(mode))
        carry = init_batched_carry(cfg, n_streams, int(mode), key)
        lowered.append(make_sharded_offline_fn(cfg, mesh).lower(
            shard_carry(carry, mesh), clips[:, :chunk]))
        lowered.append(make_offline_batched_fn(cfg).lower(
            jax.tree.map(lambda x: x[:per_dev], carry),
            clips[:per_dev, :chunk]))
    with ThreadPoolExecutor(len(lowered)) as pool:
        for fut in [pool.submit(lw.compile) for lw in lowered]:
            fut.result()
    tm.compile_s += time.perf_counter() - t
    log(f"  compiled {len(lowered)} programs in parallel in "
        f"{time.perf_counter() - t:.1f} s")

    for mode in modes:
        cfg = serve._serve_config(h, w, working, past, future, int(mode))
        t = time.perf_counter()
        outs, valid, carry = serve.stabilize_streams_sharded(
            clips, cfg, mesh, chunk=chunk, key=key)
        jax.block_until_ready(outs)
        tm.compile_s += time.perf_counter() - t
        spans = {d.id for d in outs.sharding.device_set}
        check(len(spans) == len(devs), spans)
        check(bool(np.asarray(valid).all()), "invalid output frame")
        outs = np.asarray(outs)

        # one device, the same per-device batch and the same carry lanes
        fn1 = make_offline_batched_fn(cfg)
        carry1 = init_batched_carry(cfg, n_streams, int(mode), key)
        with jax.default_device(devices[0]):
            for s0 in range(0, n_streams, per_dev):
                c1 = jax.tree.map(lambda x: jnp.asarray(x[s0:s0 + per_dev]),
                                  carry1)
                ref = []
                for i in range(0, n_frames, chunk):
                    args = (c1, clips[s0:s0 + per_dev, i:i + chunk])
                    c1, (o, _) = (tm.first_call(fn1, *args) if s0 == 0
                                  and i == 0 else fn1(*args))
                    ref.append(np.asarray(o))
                ref = np.concatenate(ref, 1)
                for j in range(per_dev):
                    np.testing.assert_array_equal(
                        outs[s0 + j], ref[j],
                        err_msg=f"{mode.name} stream {s0 + j}")
        log(f"  {mode.name}: {n_streams} streams x {n_frames} frames of "
            f"{w}x{h}, outputs sharded over {len(spans)} devices, every "
            f"stream bit-equal to one device at {per_dev} stream(s) per "
            f"batch")
    tm.done()


# ---------------------------------------------------------------- main
def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded serving check")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import video_stabilization  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke.py: cannot import the stabilizer ({e}); run it "
              f"from the repository root", file=sys.stderr)
        return 2
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py: needs a GPU, JAX's default backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1

    from video_stabilization.utils.timing import enable_compile_cache

    log(_nvidia_smi())
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}; "
        f"compile cache {enable_compile_cache()}")
    devices = jax.devices()
    if args.four:
        check(len(devices) == 4, f"--four needs 4 GPUs, found {devices}")
        four_cards(devices)
    else:
        phase_kernels()
        stab, frame, _ = phase_streaming(
            drift_bound=STREAM_DRIFT_CPU_PX + STREAM_DRIFT_MARGIN_PX)
        phase_locks()
        phase_serving()
        phase_stage_profile(stab, frame)
    for d in devices:
        log(f"{d}: peak_bytes_in_use {d.memory_stats()['peak_bytes_in_use']}")
    d0 = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
