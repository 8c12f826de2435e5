"""Multi-stream serving harness: N video streams -> stream-sharded mesh ->
per-stream stabilized outputs.

This is the replacement for the reference's single-stream main
loop (src/main_utils.cpp:459-493) at production scale
(SURVEY.md §5.8): independent video streams are the parallelism axis, the
carry pytree and frame batch are sharded over a 1-D ``jax.sharding.Mesh``
along ``streams``, and each device runs the fully batched offline chunk
pipeline on its stream shard with ZERO steady-state collectives.

Data path per chunk (all host costs overlapped with device compute by
async dispatch):

  native C++ Y4M block fread (io/native.py, one C call per stream-chunk)
    -> (S, K, bytes) planar YUV stacked on host
    -> ONE sharded H2D (1.5 B/px for C420)
    -> on-device YUV->BGR (ops/image.py yuv_flat_to_bgr)
    -> sharded offline chunk pipeline (parallel/streams.py)
    -> per-stream D2H + native Y4M writers

Run it:

  python -m video_stabilization.serve --files a.y4m b.y4m \
      --mode smoothing --output-dir out/
  python -m video_stabilization.serve --simulator 8 --frames 64 \
      --mode accumulated --output-dir out/

The in-memory entry point ``stabilize_streams_sharded`` is what
``__graft_entry__.dryrun_multichip`` and tests/test_parallel.py drive on the
virtual 8-device CPU mesh: its outputs are asserted bit-identical to the
single-device ``make_offline_batched_fn`` path (sharding only places the
independent stream lanes; it must not change their math).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np


def pick_serving_devices(devices: Sequence, n_streams: int,
                         log=print) -> list:
    """Largest device prefix that divides the stream count (NamedSharding
    needs the sharded axis divisible by the mesh axis).  Devices left out
    are logged."""
    chosen = [devices[0]]
    for d in range(min(len(devices), n_streams), 0, -1):
        if n_streams % d == 0:
            chosen = list(devices[:d])
            break
    if len(chosen) < len(devices):
        left = ", ".join(str(dv) for dv in devices[len(chosen):])
        log(f"{n_streams} stream(s) shard evenly over {len(chosen)} of "
            f"{len(devices)} devices; left out: {left}")
    return chosen


def _serve_config(h: int, w: int, working_height: int, past: int, future: int,
                  mode: int, ecc: bool = False):
    from video_stabilization.config import (
        ECCConfig, StabilizerConfig,
    )

    return StabilizerConfig(
        past_frames=past,
        future_frames=future,
        working_height=working_height,
        frame_height=h,
        frame_width=w,
        static_mode=mode,
        ecc=ECCConfig(enabled=ecc),
    )


def stabilize_streams_sharded(footage, config, mesh, chunk: int = 8,
                              key=None):
    """In-memory serving path: footage (S, T, H, W, 3) u8 -> stabilized
    (S, T, H, W, 3) u8 + validity (S, T) via the stream-sharded offline
    pipeline.  T must be a multiple of ``chunk``."""
    import jax

    from video_stabilization.parallel import (
        init_batched_carry, make_sharded_offline_fn,
    )
    from video_stabilization.parallel.streams import shard_carry

    if config.static_mode is None:
        raise ValueError("serving requires config.static_mode")
    s, t = footage.shape[:2]
    if t % chunk:
        raise ValueError(f"frame count {t} not a multiple of chunk {chunk}")
    if key is None:
        key = jax.random.key(0)
    carry = init_batched_carry(config, s, int(config.static_mode), key)
    carry = shard_carry(carry, mesh)
    fn = make_sharded_offline_fn(config, mesh)
    outs, valids = [], []
    for i in range(0, t, chunk):
        carry, (out, valid) = fn(carry, footage[:, i:i + chunk])
        outs.append(out)
        valids.append(valid)
    import jax.numpy as jnp

    return jnp.concatenate(outs, 1), jnp.concatenate(valids, 1), carry


def serve_files(paths: Sequence[str], output_dir: Optional[str], mode,
                working_height: int = 360, past: int = 60, future: int = 45,
                chunk: int = 8, max_frames: Optional[int] = None,
                devices: Optional[Sequence] = None, config=None, log=print):
    """Stream N Y4M files through the sharded pipeline; write per-stream
    stabilized Y4M files to ``output_dir`` (skipped when None).  Returns
    (frames_done_per_stream, wall_seconds)."""
    import jax
    import jax.numpy as jnp

    from video_stabilization.config import StabilizationMode
    from video_stabilization.io.native import NativeY4MReader
    from video_stabilization.io.video import VideoWriter
    from video_stabilization.ops.image import yuv_flat_to_bgr
    from video_stabilization.parallel import (
        init_batched_carry, make_sharded_offline_fn,
    )
    from video_stabilization.parallel.streams import (
        STREAM_AXIS, make_stream_mesh, shard_carry,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    readers = [NativeY4MReader(p) for p in paths]
    sizes = {r.frame_size for r in readers}
    c420s = {r.is_c420 for r in readers}
    if len(sizes) != 1 or len(c420s) != 1:
        raise ValueError(
            f"all streams must share frame size and chroma mode, got "
            f"sizes {sizes}, c420 {c420s}")
    (h, w), c420 = sizes.pop(), c420s.pop()
    s = len(readers)

    devs = pick_serving_devices(
        list(devices) if devices is not None else jax.devices(), s, log=log)
    mesh = make_stream_mesh(devs)
    log(f"serving {s} stream(s) of {w}x{h} over {len(devs)} device(s) "
        f"({devs[0].platform}), chunk {chunk}")

    if isinstance(mode, str):
        # accept both the CLI spellings ("smoothing", "orb-lock", ...) and
        # raw enum member names ("GLOBAL_SMOOTHING", ...)
        from video_stabilization.cli.args import MODE_NAMES

        mode = StabilizationMode[MODE_NAMES.get(mode, mode.upper())]
    else:
        mode = StabilizationMode(mode)
    if config is not None:                  # test/tuned override
        cfg = dataclasses.replace(
            config, frame_height=h, frame_width=w, static_mode=int(mode))
    else:
        cfg = _serve_config(h, w, working_height, past, future, int(mode),
                            ecc=(mode == StabilizationMode.SIFT_FULL_LOCK))

    offline = make_sharded_offline_fn(cfg, mesh)
    frame_sharding = NamedSharding(mesh, P(STREAM_AXIS))

    @jax.jit
    def to_bgr(yuv):                       # (S, K, bytes) -> (S, K, H, W, 3)
        return yuv_flat_to_bgr(yuv, h, w, c420)

    carry = init_batched_carry(cfg, s, int(mode), jax.random.key(0))
    carry = shard_carry(carry, mesh)

    writers = None
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        writers = [
            VideoWriter(
                os.path.join(
                    output_dir,
                    f"stabilized_{os.path.basename(p)}"),
                r.fps, (h, w), subsampling="420" if c420 else "444")
            for p, r in zip(paths, readers)
        ]

    done = 0
    t0 = time.perf_counter()
    pending = None                  # (outputs, valid) still on device
    while max_frames is None or done < max_frames:
        blocks = [r.read_yuv_block(chunk) for r in readers]
        if any(b is None or len(b) < chunk for b in blocks):
            break                   # shortest stream sets the length
        yuv = jax.device_put(np.stack(blocks), frame_sharding)
        carry, out_valid = offline(carry, to_bgr(yuv))
        # drain the PREVIOUS chunk while the device crunches this one
        if pending is not None and writers is not None:
            _drain(writers, *pending)
        pending = out_valid
        done += chunk
    if pending is not None:
        if writers is not None:
            _drain(writers, *pending)
        else:
            jax.block_until_ready(pending[0])
    dt = time.perf_counter() - t0

    for r in readers:
        r.close()
    if writers is not None:
        for wr in writers:
            wr.close()
    log(f"served {done} frames x {s} streams in {dt:.2f}s "
        f"({done * s / dt:.1f} aggregate fps)" if done else "no full chunks")
    return done, dt


def _drain(writers, outputs, valid):
    """D2H one chunk's outputs and append valid frames per stream."""
    out_np = np.asarray(outputs)            # (S, K, H, W, 3)
    val_np = np.asarray(valid)              # (S, K)
    for si, wr in enumerate(writers):
        for ki in range(out_np.shape[1]):
            if val_np[si, ki]:
                wr.write(out_np[si, ki])


def _render_sim_streams(n_streams, n_frames, h, w, log=print):
    """Simulator footage for --simulator serving (one shake trajectory per
    stream), written to temp Y4M files so the native ingest path is what
    gets exercised."""
    import tempfile

    import jax

    from video_stabilization.io.video import VideoWriter
    from video_stabilization.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame,
        shake_trajectory,
    )

    tex = make_default_texture(jax.random.key(0), size=512)
    render = jax.jit(lambda t, p: render_frame(t, p, h, w))
    tmp = tempfile.mkdtemp(prefix="vstab_serve_")
    paths = []
    for si in range(n_streams):
        traj = shake_trajectory(
            jax.random.key(5 + si), n_frames, DEFAULT_APP_PARAMS,
            pos_amplitude=0.004, roll_amplitude=0.3)
        path = os.path.join(tmp, f"stream{si}.y4m")
        wr = VideoWriter(path, 30.0, (h, w), subsampling="420")
        for i in range(n_frames):
            wr.write(np.asarray(
                render(tex, jax.tree.map(lambda x: x[i], traj))))
        wr.close()
        paths.append(path)
    log(f"rendered {n_streams} simulator streams x {n_frames} frames -> {tmp}")
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m video_stabilization.serve",
        description="Multi-stream stabilization serving over a device mesh.")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--files", nargs="+", help="input Y4M files, one per stream")
    src.add_argument("--simulator", type=int, metavar="N",
                     help="serve N synthetic simulator streams")
    ap.add_argument("--mode", default="smoothing",
                    choices=["smoothing", "accumulated", "orb", "sift",
                             "translation", "rotation"])
    ap.add_argument("--output-dir", default=None,
                    help="write stabilized_<name>.y4m per stream here")
    ap.add_argument("--working-height", type=int, default=360)
    ap.add_argument("--past-window", type=float, default=2.0,
                    help="seconds (reference default, src/main_utils.hpp:25)")
    ap.add_argument("--future-window", type=float, default=1.5)
    ap.add_argument("--fps", type=float, default=30.0,
                    help="fps used to size the temporal window")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after this many frames per stream")
    ap.add_argument("--sim-size", default="1920x1080",
                    help="WxH of --simulator streams")
    args = ap.parse_args(argv)

    mode_map = {"smoothing": "GLOBAL_SMOOTHING",
                "accumulated": "ACCUMULATED_FULL_LOCK",
                "orb": "ORB_FULL_LOCK", "sift": "SIFT_FULL_LOCK",
                "translation": "TRANSLATION_LOCK",
                "rotation": "ROTATION_LOCK"}

    paths = args.files
    if paths is None:
        w, h = (int(x) for x in args.sim_size.split("x"))
        n = args.frames or 64
        paths = _render_sim_streams(args.simulator, n, h, w)

    past = max(1, int(round(args.past_window * args.fps)))
    future = max(0, int(round(args.future_window * args.fps)))
    serve_files(paths, args.output_dir, mode_map[args.mode],
                working_height=args.working_height, past=past, future=future,
                chunk=args.chunk, max_frames=args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
