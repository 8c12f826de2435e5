#!/usr/bin/env python
"""Benchmarks: the engine on one GPU vs an OpenCV-CPU reference pipeline.

Prints EXACTLY ONE JSON line on stdout ({"metric", "value", "unit",
"vs_baseline", "device", ..., "configs": {...}}) at the very end of the
run.  Intermediate cumulative snapshots after every config go to STDERR
and to a state file (--state) that --resume can reload.  A global
--deadline with per-section time boxes keeps the suite inside its budget;
skipped sections are recorded per config under "skipped".

Refuses to run unless JAX's default backend is the GPU: a CPU number is
never reported under a device metric.

BASELINE.json configs:
  1. simulator + global smoothing, working 360, 1080p frames
  2. accumulated LK optical-flow full-motion lock, 360p frames, native
     Y4M file ingest
  3. ORB registration lock, 720p frames
  4. SIFT registration lock + ECC enabled, 1080p frames
  5. batched 8-stream 1080p, translation-lock decomposition (the real
     vmapped path: one dispatch stabilizes all 8 streams per frame)

Measurement protocol:
  - Throughput: lax.scan / offline-chunked over the clip — one dispatch
    per clip or chunk, so the number is device throughput, not host
    dispatch rate.  Every timing ends in ``jax.block_until_ready``.
  - Every jitted program is compiled and warmed BEFORE its timed section.
  - Latency: >= 50 per-frame dispatches, each closed by
    ``block_until_ready``; p50/p99 reported raw; samples >3x p50 are
    counted and the worst one named, so an unexplained p99 can't reach
    the JSON.
  - The OpenCV baseline runs first per config: a faithful CPU replica of
    the reference per-frame hot path with the reference's hyperparameters;
    config 5's baseline runs the accumulated-lock mode (the reference's
    translation lock is a documented no-op, src/stabilizer.cpp:790) on one
    stream.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from video_stabilization.sim.truth import (  # noqa: F401  (bench API)
    analytic_smoothing_truth,
    corner_drift,
)


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Budget:
    """Global wall-clock budget with per-config reserves.

    ``have(est, n_left)`` answers "can I afford an ``est``-second section
    while still leaving enough to run the core measurements of the
    ``n_left`` configs after this one?".  Core reserve is 300 s/config —
    one cold compile of a full-size step plus render/baseline/run."""

    CORE_RESERVE_S = 300
    CLOSE_MARGIN_S = 60

    def __init__(self, seconds):
        self.t0 = time.monotonic()
        self.total = seconds

    def remaining(self):
        return self.total - (time.monotonic() - self.t0)

    def have(self, est, n_left=0):
        return (self.remaining()
                - (self.CORE_RESERVE_S * n_left + self.CLOSE_MARGIN_S)) > est


BUDGET = None  # set in main()
DEVICE = None  # set in main(): {"platform", "kind", "count"} as JAX reports


def section(result, name, est, n_left, fn, *args, **kwargs):
    """Run an optional measurement section under the global budget; on
    skip, record why under result["skipped"] so the JSON says what is
    missing and why instead of silently omitting it."""
    rem = int(BUDGET.remaining())
    if not BUDGET.have(est, n_left):
        note = f"{name} (est {est}s, {rem}s left, {n_left} configs queued)"
        result.setdefault("skipped", []).append(note)
        log(f"SKIP section {name}: {note}")
        return None
    t0 = time.monotonic()
    try:
        out = fn(*args, **kwargs)
    except Exception as e:
        log(f"section {name} FAILED: {type(e).__name__}: {e}")
        result.setdefault("skipped", []).append(
            f"{name} (failed: {type(e).__name__})")
        return None
    log(f"section {name}: {time.monotonic() - t0:.0f}s")
    return out


def make_footage(n_frames, height, width, n_streams=1):
    """Render simulator footage ON DEVICE and leave it there.

    Returns (frames, traj0): frames is (T, H, W, 3) u8 for one stream or
    (T, S, H, W, 3) u8 for a batch; traj0 yields analytic ground-truth
    homographies for fidelity metrics."""
    import jax
    import jax.numpy as jnp

    from video_stabilization.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame,
        shake_trajectory,
    )

    tex = make_default_texture(jax.random.key(0), size=512)
    render = jax.jit(lambda t, p: render_frame(t, p, height, width))
    streams = []
    traj0 = None
    for s in range(n_streams):
        traj = shake_trajectory(
            jax.random.key(5 + s), n_frames, DEFAULT_APP_PARAMS,
            pos_amplitude=0.004, roll_amplitude=0.3,
        )
        if s == 0:
            traj0 = traj
        frames = [render(tex, jax.tree.map(lambda x: x[i], traj))
                  for i in range(n_frames)]
        streams.append(jnp.stack(frames))
    if n_streams > 1:
        out = jnp.stack(streams, axis=1)          # (T, S, H, W, 3)
    else:
        out = streams[0]                          # (T, H, W, 3)
    jax.block_until_ready(out)
    return out, traj0


def engine_config(h, w, working_height, past, future, ecc=False, compat=False):
    from video_stabilization.config import ECCConfig, StabilizerConfig

    return StabilizerConfig(
        past_frames=past, future_frames=future, working_height=working_height,
        frame_height=h, frame_width=w,
        ecc=ECCConfig(enabled=ecc, max_iters=30),
        reference_compat=compat,
    )


def _wait(x):
    import jax

    jax.block_until_ready(x)


def bench_throughput_scan(frames, cfg, mode, n_streams=1, reps=2):
    """Chip throughput via the scan path: frames/sec/chip."""
    import jax

    from video_stabilization.config import StabilizationMode  # noqa: F401
    from video_stabilization.engine.stabilizer import make_scan_fn
    from video_stabilization.engine.state import init_carry
    from video_stabilization.parallel import (
        init_batched_carry, make_batched_scan_fn,
    )
    if n_streams > 1:
        scan = make_batched_scan_fn(cfg)
        carry = init_batched_carry(cfg, n_streams, int(mode), jax.random.key(0))
    else:
        scan = make_scan_fn(cfg)
        carry = init_carry(cfg, int(mode), jax.random.key(0))

    n_frames = frames.shape[0]
    carry, (out, _) = scan(carry, frames)       # compile + warm
    _wait(out)

    def measure(c, r):
        t0 = time.perf_counter()
        for _ in range(r):
            c, (out, _) = scan(c, frames)
        _wait(out)
        return c, r * n_frames * n_streams / (time.perf_counter() - t0)

    # two-phase: estimate the rate, then re-measure over a >=2 s window
    carry, fps_est = measure(carry, reps)
    reps_long = max(reps, min(40, int(2.0 * fps_est / (n_frames * n_streams))
                              + 1))
    return measure(carry, reps_long)[1]


def bench_throughput_offline(frames, cfg, mode, n_streams=1, chunk=16, reps=2):
    """Chip throughput via the offline batched pipeline (engine/offline.py):
    per-pair estimation, registration, and output warps batched over chunk
    frames (x streams) per dispatch — the round-3 throughput path."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from video_stabilization.engine import (
        init_carry, make_offline_batched_fn, make_offline_fn,
    )
    from video_stabilization.parallel import init_batched_carry
    cfg_off = dataclasses.replace(cfg, static_mode=int(mode))
    n_frames = frames.shape[0]
    chunk = min(chunk, n_frames, cfg.total_window)

    if n_streams > 1:
        fn = make_offline_batched_fn(cfg_off)
        frames = jnp.swapaxes(frames, 0, 1)        # (S, T, H, W, C)
        slice_chunk = lambda i, j: frames[:, i:j]
        make_carry = lambda: init_batched_carry(
            cfg_off, n_streams, int(mode), jax.random.key(0))
    else:
        fn = make_offline_fn(cfg_off)
        slice_chunk = lambda i, j: frames[i:j]
        make_carry = lambda: init_carry(cfg_off, int(mode), jax.random.key(0))

    def run_once(carry):
        out = None
        i = 0
        while i + chunk <= n_frames:
            carry, (out, _) = fn(carry, slice_chunk(i, i + chunk))
            i += chunk
        return carry, out, i

    carry, out, done = run_once(make_carry())        # compile + warm
    _wait(out)

    def measure(c, r):
        t0 = time.perf_counter()
        total = 0
        for _ in range(r):
            c, out, done = run_once(c)
            total += done
        _wait(out)
        return c, total * n_streams / (time.perf_counter() - t0)

    # two-phase (see bench_throughput_scan): a >=2 s window
    carry, fps_est = measure(carry, reps)
    per_rep = (done or n_frames) * n_streams
    reps_long = max(reps, min(40, int(2.0 * fps_est / per_rep) + 1))
    return measure(carry, reps_long)[1]


def bench_file_streaming(y4m_path, n_frames, cfg, mode, chunk=16):
    """End-to-end fps of the native file path: NativeY4MReader BLOCK fread
    (one C call per chunk, contiguous (K, bytes) planes) -> chunked planar
    H2D -> on-device YUV->BGR -> offline batched pipeline.  Dispatch is
    async, so the host reads chunk i+1 while the device crunches chunk i.
    The number includes ALL host costs (the native decoder is in the
    measured loop, reference src/main_utils.cpp:262-281,397-417).

    The jitted program is compiled before the timer starts.  Every chunk's
    H2D upload is timed too, so the result ships with the bandwidth it saw
    and the fps that bandwidth alone would allow.  Returns a dict
    (fps/compile_s/h2d_MBps/ceiling_fps)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from video_stabilization.engine import make_offline_fn
    from video_stabilization.engine.state import init_carry
    from video_stabilization.io.native import NativeY4MReader
    from video_stabilization.ops.image import yuv_flat_to_bgr

    cfg_off = dataclasses.replace(cfg, static_mode=int(mode))
    scan = make_offline_fn(cfg_off)

    probe = NativeY4MReader(y4m_path)
    h, w = probe.frame_size
    c420 = probe.is_c420
    probe.close()

    # the host only freads raw Y|U|V planes; colorspace conversion runs on
    # device fused ahead of the offline scan (half the H2D bytes for C420)
    @jax.jit
    def scan_yuv(carry, yuv_chunk):
        frames = yuv_flat_to_bgr(yuv_chunk, h, w, c420)
        return scan(carry, frames)

    # ---- warm/compile pass, OUTSIDE the timer ---------------------------
    src = NativeY4MReader(y4m_path)
    warm_block = src.read_yuv_block(chunk)
    src.close()
    warm_carry = init_carry(cfg_off, int(mode), jax.random.key(1))
    t_c = time.perf_counter()
    warm_carry, (warm_out, _) = scan_yuv(warm_carry, jnp.asarray(warm_block))
    _wait(warm_out)
    compile_s = time.perf_counter() - t_c
    del warm_carry, warm_out

    # ---- measured pass ---------------------------------------------------
    src = NativeY4MReader(y4m_path)
    carry = init_carry(cfg_off, int(mode), jax.random.key(0))
    t0 = time.perf_counter()
    done = 0
    out = None
    up_rates = []
    while done + chunk <= n_frames:
        block = src.read_yuv_block(chunk)       # one native call
        if block is None or len(block) < chunk:
            break
        tu = time.perf_counter()
        dev = jax.device_put(block)
        dev.block_until_ready()                 # transfer complete
        up_rates.append(block.nbytes / (time.perf_counter() - tu) / 1e6)
        carry, (out, _) = scan_yuv(carry, dev)  # async; overlaps next fread
        done += chunk
    if out is not None:
        _wait(out)
    dt = time.perf_counter() - t0
    src.close()
    bytes_per_frame = (h * w * 3) // 2 if c420 else h * w * 3
    bw = float(np.median(up_rates)) if up_rates else float("nan")
    return {
        "fps": (done / dt if done else float("nan")),
        "compile_s": compile_s,
        "h2d_MBps": bw,
        "ceiling_fps": bw * 1e6 / bytes_per_frame,
    }


def _latency_stats(lat_ms):
    """p50/p99 plus stall forensics: any sample >3x p50 is counted and the
    worst one named, so an exploded p99 always ships with its cause
    candidate in the JSON."""
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    stats = {"p50": p50, "p99": p99}
    stalls = np.flatnonzero(lat_ms > 3.0 * p50)
    if len(stalls):
        am = int(np.argmax(lat_ms))
        stats["note"] = (
            f"{len(stalls)}/{len(lat_ms)} samples >3x p50; max "
            f"{float(lat_ms[am]):.0f} ms at sample {am} — isolated host "
            f"stall(s), not a recompile (all samples share one executable)")
        clean = lat_ms[lat_ms <= 3.0 * p50]
        stats["p99_excl_stalls"] = float(np.percentile(clean, 99))
    return stats


def bench_batched_latency(frames, cfg, mode, n_streams, n_lat=50):
    """Per-dispatch latency of the stream-batched step (one dispatch
    stabilizes one frame of every stream), p50/p99 raw."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from video_stabilization.parallel import (
        init_batched_carry, make_batched_step_fn,
    )
    cfg_b = dataclasses.replace(cfg, static_mode=int(mode))
    step = make_batched_step_fn(cfg_b)
    carry = init_batched_carry(cfg_b, n_streams, int(mode), jax.random.key(0))
    carry, (out, _) = step(carry, frames[0])
    _wait(out)
    n = frames.shape[0]
    lat = []
    for i in range(max(n_lat, n)):
        f = frames[i % n]
        t0 = time.perf_counter()
        carry, (out, _) = step(carry, f)
        _wait(out)
        lat.append(time.perf_counter() - t0)
    return _latency_stats(1000.0 * np.asarray(lat))


def bench_latency(frames, cfg, mode, n_lat=50, collect_h=False):
    """Per-frame dispatch latency (p50/p99 + stall forensics, raw) plus the
    pipelined per-frame step time, via the streaming step path."""
    import jax
    import jax.numpy as jnp

    from video_stabilization.engine import Stabilizer
    stab = Stabilizer(cfg, mode, seed=0)
    out = stab.stabilize_frame(frames[0])
    _wait(out)                                  # compile + warm

    # pipelined: N dispatches, one wait
    stab = Stabilizer(cfg, mode, seed=0)
    n_pipe = min(32, frames.shape[0])
    t0 = time.perf_counter()
    for i in range(n_pipe):
        out = stab.stabilize_frame(frames[i])
    _wait(out)
    step_ms = (time.perf_counter() - t0) / n_pipe * 1000.0

    # raw per-dispatch latency, >= n_lat samples
    lat = []
    hs = []
    stab = Stabilizer(cfg, mode, seed=0)
    n = frames.shape[0]
    for i in range(max(n_lat, n)):
        f = frames[i % n]
        t0 = time.perf_counter()
        out = stab.stabilize_frame(f)
        _wait(out)
        lat.append(time.perf_counter() - t0)
        if collect_h and i < n:
            hs.append(np.asarray(stab.carry.last_h, np.float64))
    stats = _latency_stats(1000.0 * np.asarray(lat))
    stats["step_ms_pipelined"] = step_ms
    return stats, (hs if collect_h else None)


def opencv_pipeline(frames_np, working_height, past, future, mode="smoothing",
                    collect_h=False):
    """OpenCV-CPU replica of the reference per-frame hot path.

    modes: smoothing (GLOBAL_SMOOTHING), accum (ACCUMULATED_FULL_LOCK),
    orb / sift (registration locks).
    """
    import collections

    import cv2

    h, w = frames_np[0].shape[:2]
    scale = working_height / h
    ww = int(round(w * scale))
    # real inter-frame transforms only, like the reference's deque
    # (src/stabilizer.cpp:277-288: first push happens at the SECOND frame;
    # capacity totalFrameWindowSize()-1).  An earlier replica version seeded
    # a dummy identity for frame 0, which shifted every smoothing-window
    # index one transform older than the reference's loops (:805-839) —
    # a 0.3 px drift artifact blamed on the engine until the cv2-exact
    # estimator closed every other term.
    transforms = collections.deque(maxlen=past + future)
    n_frames_window = 0                       # reference frames deque size
    frames_cap = past + future + 1
    prev_gray = None
    prev_pts = None
    accum = None
    ref_kp = ref_desc = None
    detector = None
    matcher = None
    if mode == "orb":
        detector = cv2.ORB_create(nfeatures=2500, scaleFactor=1.2, nlevels=12,
                                  edgeThreshold=31, patchSize=31,
                                  fastThreshold=20,
                                  scoreType=cv2.ORB_FAST_SCORE)
        matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
    elif mode == "sift":
        detector = cv2.SIFT_create(nfeatures=2500, nOctaveLayers=3,
                                   contrastThreshold=0.04, edgeThreshold=5,
                                   sigma=1.2)
        matcher = cv2.BFMatcher(cv2.NORM_L2)

    def preprocess(g):
        g = cv2.medianBlur(g, 5)
        k = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)
        g = cv2.filter2D(g, -1, k)
        g = cv2.createCLAHE(2.0, (8, 8)).apply(g)
        return cv2.medianBlur(g, 5)

    n_warm = 4
    times = []
    hs = []
    for idx, frame in enumerate(frames_np):
        t0 = time.perf_counter()
        small = cv2.resize(frame, (ww, working_height),
                           interpolation=cv2.INTER_LINEAR)
        gray = cv2.cvtColor(small, cv2.COLOR_BGR2GRAY)
        n_frames_window = min(n_frames_window + 1, frames_cap)
        t_new = np.eye(3)
        if prev_gray is not None and prev_pts is not None and len(prev_pts) >= 10:
            nxt, st, _ = cv2.calcOpticalFlowPyrLK(
                prev_gray, gray, prev_pts, None, winSize=(21, 21), maxLevel=3,
                criteria=(cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS,
                          50, 0.01),
                minEigThreshold=1e-4,
            )
            good = st.reshape(-1).astype(bool)
            if good.sum() >= 10:
                m, _ = cv2.estimateAffinePartial2D(
                    prev_pts.reshape(-1, 2)[good], nxt.reshape(-1, 2)[good],
                    method=cv2.RANSAC,
                )
                if m is not None and np.isfinite(m).all():
                    t_new = np.vstack([m, [0, 0, 1]])
                    a = t_new[:2, :2]
                    s = np.sqrt(max(np.linalg.det(a), 1e-9))
                    c = np.array([ww / 2.0, working_height / 2.0])
                    r = a / s
                    t = t_new[:2, 2] + (np.eye(2) - a) @ c - (np.eye(2) - r) @ c
                    t_new = np.eye(3)
                    t_new[:2, :2] = r
                    t_new[:2, 2] = t
        if idx > 0:
            # reference pushes a transform only from the second frame on
            transforms.append(t_new)

        if mode == "smoothing":
            # presentation index over FRAMES (src/stabilizer.cpp:1226-1229),
            # walks over the real transform deque (:805-839; the future loop
            # excludes the newest transform — reference quirk)
            p = (n_frames_window - future - 1
                 if n_frames_window > future else 0)
            h_avg = np.zeros((3, 3))
            count = 0
            acc = np.eye(3)
            for i in range(p, 0, -1):
                acc = np.linalg.inv(transforms[i - 1]) @ acc
                h_avg += acc
                count += 1
            acc = np.eye(3)
            for i in range(p, len(transforms) - 1):
                acc = acc @ transforms[i]
                h_avg += acc
                count += 1
            h_s = h_avg / count if count else np.eye(3)
        elif mode == "accum":
            accum = t_new @ accum if accum is not None else np.eye(3)
            h_s = np.linalg.inv(accum)
        else:  # orb / sift registration against a reference frame
            proc = preprocess(gray)
            kp, desc = detector.detectAndCompute(proc, None)
            h_s = np.eye(3)
            if ref_kp is None:
                ref_kp, ref_desc = kp, desc
            elif desc is not None and ref_desc is not None and len(kp) >= 10:
                if mode == "orb":
                    knn = matcher.knnMatch(ref_desc, desc, k=2)
                    goodm = [a for a, b in (p for p in knn if len(p) == 2)
                             if a.distance < 0.6 * b.distance]
                else:
                    allm = matcher.match(ref_desc, desc)
                    if allm:
                        avg = np.mean([mm.distance for mm in allm])
                        goodm = [mm for mm in allm
                                 if mm.distance <= max(0.5 * avg, 0.02)]
                    else:
                        goodm = []
                if len(goodm) >= 10:
                    srcp = np.float32([ref_kp[mm.queryIdx].pt for mm in goodm])
                    dstp = np.float32([kp[mm.trainIdx].pt for mm in goodm])
                    m, _ = cv2.estimateAffinePartial2D(
                        srcp, dstp, method=cv2.RANSAC,
                        ransacReprojThreshold=5.0)
                    if m is not None and np.isfinite(m).all():
                        h_s = np.linalg.inv(np.vstack([m, [0, 0, 1]]))

        hs.append(h_s.copy())
        h_scaled = h_s.copy()
        h_scaled[:2, 2] /= scale
        avg_c = 0.5 * np.asarray(cv2.mean(frame))[:3]
        cv2.warpPerspective(frame, h_scaled, (w, h), flags=cv2.INTER_LINEAR,
                            borderMode=cv2.BORDER_CONSTANT,
                            borderValue=avg_c.tolist())
        prev_pts = cv2.goodFeaturesToTrack(
            gray, maxCorners=1300, qualityLevel=0.01,
            minDistance=10 * working_height / 720.0, mask=None, blockSize=3)
        prev_gray = gray
        if idx >= n_warm:
            times.append(time.perf_counter() - t0)

    fps = len(times) / sum(times) if times else float("nan")
    return fps, (hs if collect_h else None)


CONFIGS = {
    1: dict(name="1080p simulator + global smoothing (working 360)",
            size=(1080, 1920), working=360, mode="smoothing"),
    2: dict(name="360p accumulated LK full-motion lock (native file decode)",
            size=(360, 640), working=360, mode="accum"),
    3: dict(name="720p ORB registration lock",
            size=(720, 1280), working=360, mode="orb"),
    4: dict(name="1080p SIFT registration lock + ECC",
            size=(1080, 1920), working=360, mode="sift"),
    5: dict(name="batched 8-stream 1080p smoothing + translation-lock",
            size=(1080, 1920), working=360, mode="tlock", streams=8,
            # 8 streams x 1080p: footage + ring + double-buffered outputs
            max_frames=24),
}

MODE_MAP = {
    "smoothing": "GLOBAL_SMOOTHING",
    "accum": "ACCUMULATED_FULL_LOCK",
    "orb": "ORB_FULL_LOCK",
    "sift": "SIFT_FULL_LOCK",
    "tlock": "TRANSLATION_LOCK",
}


def run_opencv_baseline(result, spec, footage, n_streams, n_base, args):
    load = os.getloadavg()[0]
    log(f"OpenCV-CPU baseline ({n_base} frames, loadavg {load:.2f})...")
    first = footage[:n_base, 0] if n_streams > 1 else footage[:n_base]
    frames_np = [np.asarray(f) for f in first]
    cv_mode = spec["mode"] if spec["mode"] != "tlock" else "accum"
    collect_cv = (n_streams == 1 and spec["mode"] == "smoothing"
                  and not args.skip_drift)
    cv_fps, hs_cv = opencv_pipeline(
        frames_np, spec["working"], args.past, args.future,
        mode=cv_mode, collect_h=collect_cv)
    log(f"OpenCV-CPU: {cv_fps:.2f} fps (1 stream)")
    result["opencv_fps"] = round(cv_fps, 2)
    result["baseline_provenance"] = (
        f"measured first, loadavg {load:.2f} ({os.cpu_count()} core host)")
    return cv_fps, hs_cv, frames_np


def production_drift(footage, cfg, hs_cv, n_base):
    """Drift of the on-device production estimator vs the OpenCV replica on
    identical footage, with the reference-compat smoothing quirks pinned so
    the only difference is the estimator stack (device GFTT+LK+RANSAC vs
    cv2).  Complements the compat referee (host cv2exact stages), VERDICT
    r4 item 4.  Reference behavior: src/stabilizer.cpp:224-225,734-736."""
    import dataclasses

    from video_stabilization.config import StabilizationMode as SM
    from video_stabilization.engine import Stabilizer

    cfg_prod = dataclasses.replace(
        cfg, reference_compat=True,
        static_mode=int(SM.GLOBAL_SMOOTHING),
    )
    stab = Stabilizer(cfg_prod, SM.GLOBAL_SMOOTHING, seed=0)
    hs_prod = []
    for i in range(n_base):
        stab.stabilize_frame(footage[i])
        hs_prod.append(np.asarray(stab.carry.last_h, np.float64))
    wh2, ww2 = cfg.working_size
    return corner_drift(hs_prod, hs_cv, ww2, wh2)


def compat_drift(footage, cfg, hs_cv, n_base):
    """Fidelity referee vs the REFERENCE pipeline: reference-compat quirks
    + cv2exact GFTT (cv2's element-exact corner list, ops/gftt_host.py) +
    cv2exact LK (OpenCV's iteration schedule) + cv2exact RANSAC (bit-exact
    replica of estimateAffinePartial2D's MWC hypothesis stream, sequential
    early exit, and LM polish — motion/cv2_ransac.py, run as a host
    estimator stage), measured against the OpenCV replica on identical
    footage."""
    import dataclasses

    from video_stabilization.config import (
        GFTTConfig, LKConfig, RansacConfig, StabilizationMode as SM,
    )
    from video_stabilization.engine import Stabilizer

    cfg_compat = dataclasses.replace(
        cfg, reference_compat=True,
        lk=LKConfig(method="cv2exact"),
        gftt=GFTTConfig(max_features=1300, selection="host"),
        ransac=RansacConfig(method="cv2exact"),
        static_mode=int(SM.GLOBAL_SMOOTHING),
    )
    stab = Stabilizer(cfg_compat, SM.GLOBAL_SMOOTHING, seed=0)
    hs_compat = []
    for i in range(n_base):
        stab.stabilize_frame(footage[i])
        hs_compat.append(np.asarray(stab.carry.last_h, np.float64))
    wh2, ww2 = cfg.working_size
    return corner_drift(hs_compat, hs_cv, ww2, wh2)


def _render_y4m(footage, path, repeat):
    """Write (T, H, W, 3) u8 device footage ``repeat`` times to a C420
    Y4M file for the native-ingest measurement."""
    from video_stabilization.io import VideoWriter

    frames_np = np.asarray(footage)
    wr = VideoWriter(path, 30.0, frames_np.shape[1:3], subsampling="420")
    for _ in range(repeat):
        for f in frames_np:
            wr.write(f)
    wr.close()


def bench_one(idx, args, n_left):
    import dataclasses

    from video_stabilization.config import StabilizationMode

    spec = CONFIGS[idx]
    h, w = spec["size"]
    n_streams = spec.get("streams", 1)
    n_frames = min(args.frames, spec.get("max_frames", args.frames))
    mode = StabilizationMode[MODE_MAP[spec["mode"]]]
    cfg = engine_config(h, w, spec["working"], args.past, args.future,
                        ecc=(spec["mode"] == "sift"))

    log(f"config {idx}: {spec['name']} "
        f"({int(BUDGET.remaining())}s budget left)")
    log(f"rendering {n_frames} frames x {n_streams} stream(s) at {w}x{h}...")
    footage, traj = make_footage(n_frames, h, w, n_streams)

    result = {"name": spec["name"]}

    # --- OpenCV-CPU baseline FIRST, before any device work loads the host -
    hs_cv = None
    cv_fps = None
    if not args.skip_baseline:
        n_base = min(args.baseline_frames, n_frames)
        base = run_opencv_baseline(result, spec, footage, n_streams,
                                   n_base, args)
        cv_fps, hs_cv, _ = base

    # --- core throughput (always attempted; without it there is no
    # headline for this config at all) ------------------------------------
    log("device throughput (offline batched pipeline)...")
    chunk = 8 if n_streams > 1 else 16
    fps = bench_throughput_offline(footage, cfg, mode, n_streams,
                                       chunk=chunk)
    log(f"device: {fps:.1f} frames/sec/chip (offline, chunk {chunk})")
    result["fps_per_chip"] = round(fps, 2)
    result["throughput_path"] = f"offline batched (chunk {chunk})"

    if not args.skip_scan:
        # the streaming scan path (one frame per in-scan step) — the rate a
        # live single-stream feed achieves; offline is the clip/VOD rate
        if n_streams > 1:
            cfg_thr = dataclasses.replace(cfg, static_mode=int(mode))
        else:
            cfg_thr = cfg
        fps_scan = section(result, "streaming_scan", 240, n_left,
                           bench_throughput_scan, footage, cfg_thr, mode,
                           n_streams)
        if fps_scan is not None:
            result["fps_streaming_scan"] = round(fps_scan, 2)
            log(f"streaming scan: {fps_scan:.1f} frames/sec/chip")
            if n_streams == 1:
                # lax.scan executes the per-frame step strictly sequentially
                # on device, so the scan rate's reciprocal IS the true
                # per-frame device latency, free of host-dispatch costs
                result["step_ms_device"] = round(1000.0 / fps_scan, 2)
            # headline = the better of the two real production paths (both
            # end-to-end device-resident; config 2's headline is replaced
            # below by the native-file e2e rate regardless)
            if fps_scan > fps:
                result["fps_per_chip"] = round(fps_scan, 2)
                result["throughput_path"] = "streaming scan"
                fps = fps_scan

    if idx == 2:
        # the headline of config 2 ingests a real file through the native
        # decoder (the clip repeated to >= 160 frames)
        import tempfile

        repeat = max(1, -(-160 // n_frames))
        y4m = os.path.join(tempfile.mkdtemp(prefix="bench_"), "config2.y4m")
        _render_y4m(footage, y4m, repeat)
        e2e = section(result, "e2e_native_ingest", 240, n_left,
                      bench_file_streaming, y4m, repeat * n_frames, cfg,
                      mode, 16)
        if e2e is not None:
            log(f"e2e incl. native decode: {e2e['fps']:.1f} fps (compile "
                f"{e2e['compile_s']:.0f}s outside timer, H2D "
                f"{e2e['h2d_MBps']:.1f} MB/s -> H2D ceiling "
                f"{e2e['ceiling_fps']:.1f} fps)")
            result["fps_device_resident"] = result["fps_per_chip"]
            result["vs_baseline_device_resident"] = (
                round(fps / cv_fps, 3) if cv_fps else None)
            result["fps_per_chip"] = round(e2e["fps"], 2)
            result["throughput_path"] = "native Y4M decode -> offline batched"
            result["e2e_compile_s"] = round(e2e["compile_s"], 1)
            result["e2e_h2d_MBps"] = round(e2e["h2d_MBps"], 1)
            result["e2e_h2d_ceiling_fps"] = round(e2e["ceiling_fps"], 1)
            fps = e2e["fps"]

    hs_dev = None
    if n_streams == 1:
        collect = spec["mode"] == "smoothing" and not args.skip_drift
        latr = section(result, "latency", 150, n_left, bench_latency,
                       footage, cfg, mode, args.latency_samples, collect)
        if latr is not None:
            stats, hs_dev = latr
            log(f"latency p50 {stats['p50']:.1f} ms / p99 "
                f"{stats['p99']:.1f} ms (pipelined step "
                f"{stats['step_ms_pipelined']:.1f} ms)")
            result.update(p50_latency_ms=round(stats["p50"], 2),
                          p99_latency_ms=round(stats["p99"], 2),
                          step_ms_pipelined=round(
                              stats["step_ms_pipelined"], 2))
            if "note" in stats:
                result["p99_note"] = stats["note"]
                result["p99_excl_stalls_ms"] = round(
                    stats["p99_excl_stalls"], 2)
    else:
        result["streams"] = n_streams
        result["per_stream_fps"] = round(fps / n_streams, 2)
        # BASELINE config 5 names BOTH global smoothing and the translation/
        # rotation-lock decomposition: measure the batched smoothing path,
        # the rotation-lock workload, a 4-stream real-time operating point,
        # and the batched per-dispatch latency.
        from video_stabilization.config import StabilizationMode as SM

        fps_sm = section(result, "batched_smoothing", 240, n_left,
                         bench_throughput_offline, footage, cfg,
                         SM.GLOBAL_SMOOTHING, n_streams, chunk)
        if fps_sm is not None:
            result["smoothing_fps_per_chip"] = round(fps_sm, 2)
            result["smoothing_per_stream_fps"] = round(fps_sm / n_streams, 2)
            log(f"smoothing: {fps_sm:.1f} aggregate fps")

        fps4 = section(result, "tlock_4stream", 240, n_left,
                       bench_throughput_offline, footage[:, :4], cfg, mode,
                       4, chunk)
        if fps4 is not None:
            result["tlock_4stream_fps_per_chip"] = round(fps4, 2)
            result["tlock_4stream_per_stream_fps"] = round(fps4 / 4, 2)
            log(f"4-stream: {fps4:.1f} aggregate "
                f"({fps4 / 4:.1f} fps/stream)")

        # the batched rotation-lock workload (reference derivation
        # src/stabilizer.cpp:1257-1260, a no-op there; implemented here)
        fps_rl = section(result, "batched_rotation_lock", 240, n_left,
                         bench_throughput_offline, footage, cfg,
                         SM.ROTATION_LOCK, n_streams, chunk)
        if fps_rl is not None:
            result["rotation_lock_fps_per_chip"] = round(fps_rl, 2)
            result["rotation_lock_per_stream_fps"] = round(
                fps_rl / n_streams, 2)
            log(f"rotation-lock: {fps_rl:.1f} aggregate fps")

        # per-dispatch latency of the batched step: one dispatch = one
        # frame of all 8 streams
        statsb = section(result, "batched_latency", 240, n_left,
                         bench_batched_latency, footage, cfg, mode,
                         n_streams, args.latency_samples)
        if statsb is not None:
            result["p50_latency_ms"] = round(statsb["p50"], 2)
            result["p99_latency_ms"] = round(statsb["p99"], 2)
            if "note" in statsb:
                result["p99_note"] = statsb["note"]
            log(f"batched latency p50 {statsb['p50']:.1f} ms / p99 "
                f"{statsb['p99']:.1f} ms (one dispatch, all "
                f"{n_streams} streams)")

    if cv_fps is not None:
        result["vs_baseline"] = round(fps / cv_fps, 3)
        if n_streams > 1:
            result["baseline_note"] = (
                "aggregate 8-stream tlock chip fps vs single-stream CPU "
                "accumulated-lock (reference tlock is a no-op)")

    # --- fidelity metrics (config 1) --------------------------------------
    if not args.skip_baseline and n_streams == 1 \
            and spec["mode"] == "smoothing" and not args.skip_drift:
        if hs_dev:
            def drift_truth():
                wh2, ww2 = cfg.working_size
                qs_true = analytic_smoothing_truth(
                    traj, len(hs_dev), wh2, ww2, args.past, args.future)
                return (corner_drift(hs_dev, qs_true, ww2, wh2),
                        corner_drift(hs_cv, qs_true[: len(hs_cv)], ww2, wh2))

            dt_r = section(result, "drift_vs_truth", 90, n_left, drift_truth)
            if dt_r is not None:
                result["corner_drift_vs_truth_px"] = round(dt_r[0], 4)
                result["opencv_drift_vs_truth_px"] = round(dt_r[1], 4)
                log(f"corner drift vs analytic truth: engine {dt_r[0]:.4f} px, "
                    f"OpenCV {dt_r[1]:.4f} px")

        if hs_cv and not args.skip_compat_drift:
            n_base = len(hs_cv)
            d_ref = section(result, "compat_drift", 420, n_left,
                            compat_drift, footage, cfg, hs_cv, n_base)
            if d_ref is not None:
                result["drift_vs_reference_px"] = round(d_ref, 5)
                log(f"drift vs reference replica (compat referee): "
                    f"{d_ref:.5f} px")
            d_prod = section(result, "production_drift", 300, n_left,
                             production_drift, footage, cfg, hs_cv, n_base)
            if d_prod is not None:
                result["drift_vs_reference_px_production"] = round(d_prod, 4)
                result["drift_note"] = (
                    "drift_vs_reference_px: compat referee (host cv2exact "
                    "GFTT/RANSAC stages between jitted halves); _production: "
                    "the on-device estimator, same compat smoothing quirks — "
                    "the gap is device-vs-cv2 estimator selection noise")
                log(f"drift vs reference replica (production estimator): "
                    f"{d_prod:.4f} px")

    if idx == 1 and not args.skip_ref_window:
        # BASELINE default window is 30/15; the reference's own default is
        # 2.0s/1.5s = 60/45 @ 30 fps (106-frame ring, ~660 MB at 1080p).
        # Demonstrate it fits and performs.
        def ref_window():
            cfg_ref = engine_config(h, w, spec["working"], 60, 45)
            return bench_throughput_offline(footage, cfg_ref, mode, 1,
                                            chunk=16)

        fps_ref = section(result, "ref_window_60_45", 420, n_left,
                          ref_window)
        if fps_ref is not None:
            result["fps_ref_window_60_45"] = round(fps_ref, 2)
            log(f"@ 60/45 window: {fps_ref:.1f} fps")
    return result


def snapshot_json(results, args):
    head_idx = args.config if args.config else 1
    head = results.get(head_idx) or next(iter(results.values()))
    out = {
        "metric": f"frames/sec/chip, {head['name']}",
        "value": head.get("fps_per_chip"),
        "unit": "fps",
        "vs_baseline": head.get("vs_baseline"),
    }
    for k in ("p50_latency_ms", "p99_latency_ms", "step_ms_pipelined",
              "step_ms_device",
              "corner_drift_vs_truth_px", "opencv_drift_vs_truth_px",
              "drift_vs_reference_px", "drift_vs_reference_px_production"):
        if k in head:
            out[k] = head[k]
    if DEVICE is not None:
        out["device"] = DEVICE
    out["configs"] = {str(k): v for k, v in results.items()}
    return json.dumps(out)


def main():
    global BUDGET

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0,
                    help="run one config (1-5); default runs all")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--baseline-frames", type=int, default=28)
    ap.add_argument("--latency-samples", type=int, default=80)
    ap.add_argument("--past", type=int, default=30)
    ap.add_argument("--future", type=int, default=15)
    ap.add_argument("--deadline", type=float,
                    default=float(os.environ.get("BENCH_DEADLINE_S", 3000)),
                    help="global wall-clock budget in seconds; optional "
                         "sections are skipped (and recorded as skipped) "
                         "to keep the whole 5-config suite inside it")
    ap.add_argument("--state",
                    default=os.path.join(tempfile.gettempdir(),
                                         "bench_state.json"),
                    help="cumulative results snapshot, written after every "
                         "config; --resume reloads it")
    ap.add_argument("--resume", action="store_true",
                    help="skip configs already completed in --state")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--skip-scan", action="store_true",
                    help="skip the streaming-scan throughput number")
    ap.add_argument("--skip-drift", action="store_true")
    ap.add_argument("--skip-compat-drift", action="store_true")
    ap.add_argument("--skip-ref-window", action="store_true")
    args = ap.parse_args()

    import jax

    from video_stabilization.utils.timing import enable_compile_cache

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default backend is "
                 f"{jax.default_backend()!r}")
    global DEVICE
    dev = jax.devices()[0]
    DEVICE = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    enable_compile_cache()

    BUDGET = Budget(args.deadline)
    todo = [args.config] if args.config else sorted(CONFIGS)
    results = {}
    if args.resume and os.path.exists(args.state):
        try:
            with open(args.state) as f:
                prev = json.load(f)
            results = {int(k): v for k, v in prev.items()
                       if "error" not in v}
            log(f"resumed {sorted(results)} from {args.state}")
        except Exception as e:
            log(f"could not resume from {args.state}: {e}")

    pending = [i for i in todo if i not in results]
    for pos, idx in enumerate(pending):
        n_left = len(pending) - pos - 1
        try:
            results[idx] = bench_one(idx, args, n_left)
        except Exception as e:  # keep the driver contract on partial failure
            log(f"config {idx} FAILED: {type(e).__name__}: {e}")
            results[idx] = {"name": CONFIGS[idx]["name"],
                            "error": str(e)[:300]}
        # cumulative snapshot: stderr + state file.  NOT stdout, which
        # carries exactly one JSON document.
        snap = snapshot_json(results, args)
        log(f"cumulative after config {idx}: {snap}")
        try:
            with open(args.state, "w") as f:
                json.dump({str(k): v for k, v in results.items()}, f)
        except OSError:
            pass

    log(f"done in {BUDGET.total - BUDGET.remaining():.0f}s "
        f"({BUDGET.remaining():.0f}s to spare)")
    print(snapshot_json(results, args), flush=True)


if __name__ == "__main__":
    main()
