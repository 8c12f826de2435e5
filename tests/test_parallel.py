"""Multi-stream batching + mesh sharding tests (virtual 8-device CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.config import (
    GFTTConfig,
    LKConfig,
    RansacConfig,
    StabilizationMode,
    StabilizerConfig,
)
from video_stabilization.parallel import (
    init_batched_carry,
    make_batched_step_fn,
    make_sharded_step_fn,
    make_stream_mesh,
)
from video_stabilization.parallel.streams import STREAM_AXIS, shard_carry
from video_stabilization.sim import (
    DEFAULT_APP_PARAMS,
    make_default_texture,
    render_frame,
    shake_trajectory,
)

FH, FW = 120, 160


def tiny_config():
    # static_mode pins the smoothing branch at trace time — the recommended
    # batched-throughput configuration (a vmapped lax.switch would compile
    # AND run every lock branch per stream; see config.StabilizerConfig).
    # It also keeps these tests within CI time budgets on 1-CPU hosts:
    # static/dynamic equivalence is covered by test_engine.TestStaticMode,
    # and the full dynamic-switch compile by TestGraftEntry's dryrun.
    return StabilizerConfig(
        past_frames=4, future_frames=2, working_height=100,
        frame_height=FH, frame_width=FW,
        gftt=GFTTConfig(max_features=128),
        lk=LKConfig(max_iters=10),
        ransac=RansacConfig(num_hypotheses=64),
        static_mode=int(StabilizationMode.GLOBAL_SMOOTHING),
    )


@pytest.fixture(scope="module")
def stream_frames():
    tex = make_default_texture(jax.random.key(0), size=128)
    frames = []
    for s in range(4):
        traj = shake_trajectory(jax.random.key(s), 6, DEFAULT_APP_PARAMS,
                                pos_amplitude=0.003)
        frames.append(jax.vmap(lambda p: render_frame(tex, p, FH, FW))(traj))
    return jnp.stack(frames, axis=1)  # (T, S, H, W, 3)


class TestBatchedStep:
    def test_batched_matches_single(self, stream_frames):
        cfg = tiny_config()
        n_streams = stream_frames.shape[1]
        bstep = make_batched_step_fn(cfg)
        bcarry = init_batched_carry(cfg, n_streams, 0, jax.random.key(7))

        from video_stabilization.engine import make_step_fn

        sstep = make_step_fn(cfg)
        # slice per-stream carries out of the batched one so PRNG keys match
        scarrys = [
            jax.tree.map(lambda leaf: leaf[i], bcarry)
            for i in range(n_streams)
        ]

        for t in range(stream_frames.shape[0]):
            bcarry, (bout, _) = bstep(bcarry, stream_frames[t])
            for s in range(n_streams):
                scarrys[s], (sout, _) = sstep(scarrys[s], stream_frames[t, s])
                # vmap changes XLA fusion/contraction order, so a handful of
                # pixels sitting exactly on a .5 rounding boundary may flip
                # by one uint8 step; anything larger is a real divergence
                diff = np.abs(
                    np.asarray(bout[s]).astype(np.int16)
                    - np.asarray(sout).astype(np.int16)
                )
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (
                    f"stream {s} frame {t} diverged: max {diff.max()}, "
                    f"{(diff > 0).mean():.2%} pixels differ"
                )


class TestShardedStep:
    def test_runs_on_8_device_mesh(self, stream_frames):
        assert len(jax.devices()) == 8
        cfg = tiny_config()
        mesh = make_stream_mesh()
        step = make_sharded_step_fn(cfg, mesh)
        carry = init_batched_carry(cfg, 8, 0, jax.random.key(1))
        carry = shard_carry(carry, mesh)
        frames = jnp.tile(stream_frames[0, :1], (8, 1, 1, 1))
        for t in range(3):
            carry, (out, valid) = step(carry, frames)
        assert out.shape == (8, FH, FW, 3)
        # carry stays sharded across steps
        shardings = {str(leaf.sharding.spec) for leaf in jax.tree.leaves(carry)
                     if hasattr(leaf, "sharding") and hasattr(leaf.sharding, "spec")}
        assert any(STREAM_AXIS in s for s in shardings)

    def test_sharded_matches_batched(self, stream_frames):
        cfg = tiny_config()
        mesh = make_stream_mesh()
        sstep = make_sharded_step_fn(cfg, mesh)
        bstep = make_batched_step_fn(cfg)
        carry0 = init_batched_carry(cfg, 8, 0, jax.random.key(2))
        frames = jnp.tile(stream_frames[0, :1], (8, 1, 1, 1))

        cs = shard_carry(carry0, mesh)
        cb = carry0
        for t in range(2):
            cs, (outs, _) = sstep(cs, frames)
            cb, (outb, _) = bstep(cb, frames)
        np.testing.assert_array_equal(np.asarray(outs), np.asarray(outb))

    def test_sharded_offline_matches_streaming(self, stream_frames):
        """Multi-chip offline throughput path: streams sharded over the
        8-device mesh, a K-frame chunk batched per stream — must agree with
        the per-stream streaming step (uint8 outputs, +-1 rounding flips
        from batched float order allowed)."""
        from video_stabilization.engine import make_step_fn
        from video_stabilization.parallel import make_sharded_offline_fn

        cfg = tiny_config()
        mesh = make_stream_mesh()
        n_streams, k = 8, 3
        frames = jnp.tile(stream_frames[:k, :1], (1, n_streams, 1, 1, 1))
        frames_sk = jnp.swapaxes(frames, 0, 1)        # (S, K, H, W, C)

        carry0 = init_batched_carry(cfg, n_streams, 0, jax.random.key(3))
        offline = make_sharded_offline_fn(cfg, mesh)
        co = shard_carry(carry0, mesh)
        co, (outs_o, _) = offline(co, frames_sk)

        sstep = make_step_fn(cfg)
        c1 = jax.tree.map(lambda leaf: leaf[0], carry0)
        outs_s = []
        for t in range(k):
            c1, (out, _) = sstep(c1, frames[t, 0])
            outs_s.append(np.asarray(out))
        diff = np.abs(np.asarray(outs_o[0]).astype(np.int16)
                      - np.stack(outs_s).astype(np.int16))
        assert diff.max() <= 1
        assert int(co.n[0]) == k


class TestServeHarness:
    def test_serve_files_matches_in_memory(self, stream_frames, tmp_path):
        """The serving harness (serve.py): native Y4M block ingest ->
        stream-sharded offline pipeline -> per-stream writers.  Outputs must
        match the in-memory sharded path exactly (same C420-decoded pixels
        in, same engine, writers just encode what came out).  VERDICT r3
        item 7."""
        from video_stabilization.io.native import NativeY4MReader
        from video_stabilization.io.video import VideoWriter
        from video_stabilization.ops.image import yuv_flat_to_bgr
        from video_stabilization.serve import (
            pick_serving_devices, serve_files, stabilize_streams_sharded,
        )

        cfg = tiny_config()
        n_streams, t = 4, 4
        paths = []
        for s in range(n_streams):
            p = str(tmp_path / f"in{s}.y4m")
            wr = VideoWriter(p, 30.0, (FH, FW), subsampling="420")
            for i in range(t):
                wr.write(np.asarray(stream_frames[i, s]))
            wr.close()
            paths.append(p)

        out_dir = str(tmp_path / "out")
        done, _ = serve_files(paths, out_dir, "smoothing", chunk=2,
                              config=cfg, log=lambda *a: None)
        assert done == t

        # reference: decode the same C420 files, run the in-memory sharded path
        from video_stabilization.parallel import make_stream_mesh

        decoded = []
        for p in paths:
            r = NativeY4MReader(p)
            blk = r.read_yuv_block(t)
            decoded.append(np.asarray(
                yuv_flat_to_bgr(jnp.asarray(blk), FH, FW, True)))
            r.close()
        footage = jnp.asarray(np.stack(decoded))       # (S, T, H, W, 3)
        mesh = make_stream_mesh(
            pick_serving_devices(jax.devices(), n_streams))
        outs, valid, _ = stabilize_streams_sharded(footage, cfg, mesh, chunk=2)

        for s in range(n_streams):
            rd = NativeY4MReader(
                str(tmp_path / "out" / f"stabilized_in{s}.y4m"))
            got = []
            while True:
                f = rd.read()
                if f is None:
                    break
                got.append(f)
            rd.close()
            want = np.asarray(outs[s])[np.asarray(valid[s])]
            assert len(got) == len(want)
            # writer re-encodes BGR->C420->BGR: chroma is box-subsampled, so
            # compare through one round trip of the SAME transform
            for g, w_ in zip(got, want):
                wr2 = VideoWriter(str(tmp_path / "rt.y4m"), 30.0, (FH, FW),
                                  subsampling="420")
                wr2.write(w_)
                wr2.close()
                r2 = NativeY4MReader(str(tmp_path / "rt.y4m"))
                np.testing.assert_array_equal(g, r2.read())
                r2.close()


class TestGraftEntry:
    def test_entry(self):
        import __graft_entry__

        fn, args = __graft_entry__.entry()
        carry, (out, valid) = jax.jit(fn)(*args)
        assert out.shape == args[1].shape

    def test_dryrun_multichip(self):
        import __graft_entry__

        __graft_entry__.dryrun_multichip(8)


class TestServeModeNames:
    def test_serve_files_accepts_cli_and_enum_spellings(self, tmp_path):
        """serve_files must accept both CLI spellings ("smoothing") and raw
        enum names ("GLOBAL_SMOOTHING") — regression for the KeyError that
        broke the library-API path (serve.py mode resolution)."""
        from video_stabilization.io.video import VideoWriter
        from video_stabilization.serve import serve_files

        p = str(tmp_path / "in.y4m")
        wr = VideoWriter(p, 30.0, (FH, FW), subsampling="420")
        rng = np.random.default_rng(0)
        for _ in range(3):
            wr.write(rng.integers(0, 255, (FH, FW, 3), dtype=np.uint8))
        wr.close()
        for mode in ("smoothing", "GLOBAL_SMOOTHING", "accumulated-lock"):
            done, _ = serve_files([p], None, mode, chunk=1,
                                  config=tiny_config(), log=lambda *a: None)
            assert done == 3
