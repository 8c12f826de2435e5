"""Platform plumbing: compile-cache placement, the chip smoke script's
refusal off the GPU, the GPU trace reduction, serving-device choice, and
the ops on the card (``gpu``-marked, skipped without one)."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stabilization.utils.stage_profile import (
    build_stage_map, device_ms_per_call, reduce_device_trace,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_extra=None, env_drop=(), cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


_CACHE_PROBE = (
    "import sys, jax; sys.path.insert(0, %r);"
    "from video_stabilization.utils.timing import enable_compile_cache;"
    "p = enable_compile_cache();"
    "print(p); print(jax.config.jax_compilation_cache_dir);"
    "print(jax.config.jax_persistent_cache_min_compile_time_secs)" % REPO)


class TestCompileCache:
    def test_env_var_is_used_and_nothing_is_set(self, tmp_path):
        want = str(tmp_path / "cache")
        r = _python(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": want})
        assert r.returncode == 0, r.stderr
        ret, cfg, min_s = r.stdout.split()
        assert ret == want and cfg == want
        assert float(min_s) == 1e9        # CPU: read-only

    def test_default_is_repo_jax_cache(self):
        r = _python(_CACHE_PROBE, env_drop=("JAX_COMPILATION_CACHE_DIR",))
        assert r.returncode == 0, r.stderr
        ret, cfg, _ = r.stdout.split()
        assert ret == cfg == os.path.join(REPO, ".jax_cache")


class TestChipSmoke:
    def test_refuses_cpu_backend(self):
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "chip_smoke.py")],
            env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=REPO,
            capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "GPU" in r.stderr

    def test_refuses_without_the_package(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                           cwd=tmp_path, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def _event(kernel, dur_ns, **stats):
    return SimpleNamespace(name=kernel, duration_ns=dur_ns,
                           stats=list(stats.items()))


def _gpu_plane(events, name="/device:GPU:0"):
    """Laid out like a trace read off an H100: one plane per card, one line
    per CUDA stream, the HLO instruction in the ``hlo_op`` stat."""
    return SimpleNamespace(name=name, lines=[
        SimpleNamespace(name="Stream #13(Compute)", events=events)])


_HOST = SimpleNamespace(name="/host:CPU", lines=[SimpleNamespace(
    name="python", events=[_event("$profiler.py trace", 5_000_000)])])


class TestGpuTraceReduction:
    STAGES = {"loop_multiply_fusion": "stage_a",
              "%input_reduce_fusion": "stage_a"}

    def _planes(self):
        return [_HOST, _gpu_plane([
            # mapped through the HLO stage map (no scope in its stats)
            _event("loop_multiply_fusion", 2_000, hlo_op="loop_multiply_fusion",
                   hlo_module="jit_step", name="jit(step)/stage_a"),
            _event("input_reduce_fusion", 1_000, hlo_op="input_reduce_fusion",
                   hlo_module="jit_step"),
            # a library kernel: attributed by the scope path in "name"
            _event("sm90_xmma_gemm_f32f32_tf32f32", 4_000,
                   hlo_op="custom-call.1", hlo_module="jit_step",
                   name="jit(step)/stage_b/stage_b_inner/dot_general"),
            # in the module, under no stage
            _event("loop_add_fusion", 500, hlo_op="loop_add_fusion",
                   hlo_module="jit_step", name="jit(step)/add"),
            # another program's kernel
            _event("loop_convert_fusion", 9_000, hlo_op="loop_convert_fusion",
                   hlo_module="jit_other", name="jit(other)/stage_a"),
        ])]

    def test_attributes_by_stage_map_then_scope(self):
        ms = reduce_device_trace(self._planes(), self.STAGES, "jit_step")
        assert ms["stage_a"] == pytest.approx(3e-3)
        assert ms["stage_b_inner"] == pytest.approx(4e-3)
        assert ms["other"] == pytest.approx(0.5e-3)
        assert ms["total"] == pytest.approx(7.5e-3)
        parts = sum(v for k, v in ms.items() if k != "total")
        assert parts == pytest.approx(ms["total"])

    def test_without_module_filter_counts_every_kernel(self):
        ms = reduce_device_trace(self._planes(), self.STAGES)
        assert ms["total"] == pytest.approx(16.5e-3)
        assert ms["stage_a"] == pytest.approx(12e-3)

    def test_raises_when_nothing_is_attributed(self):
        planes = [_gpu_plane([_event("memcpy", 100, hlo_module="jit_step")])]
        with pytest.raises(RuntimeError, match="no event attributed"):
            reduce_device_trace(planes, {}, "jit_step")

    def test_no_device_plane_is_empty(self):
        assert reduce_device_trace([_HOST], self.STAGES) == {}

    def test_stage_map_from_compiled_hlo(self):
        """The instruction names the map gives are the ones a GPU trace
        carries in ``hlo_op``: feed them back as events."""
        @jax.jit
        def step(x):
            with jax.named_scope("stage_a"):
                y = jnp.sin(x) * 2.0
            with jax.named_scope("stage_b"):
                z = jnp.cumsum(y, axis=0)
            return z

        hlo = step.lower(jnp.ones((64, 64))).compile().as_text()
        smap = build_stage_map(hlo)
        assert set(smap.values()) <= {"stage_a", "stage_b"} and smap
        events = [_event(op.lstrip("%"), 1_000, hlo_op=op.lstrip("%"))
                  for op in smap]
        ms = reduce_device_trace([_gpu_plane(events)], smap)
        assert ms["other"] == 0.0
        assert sum(v for k, v in ms.items() if k.startswith("stage_")) == \
            pytest.approx(ms["total"])

    def test_device_ms_per_call_is_none_on_cpu(self):
        f = jax.jit(lambda x: x * 2.0)
        x = jnp.ones((8,))
        assert device_ms_per_call(lambda: f(x).block_until_ready()) is None


class TestServingDevices:
    def test_logs_devices_left_out(self):
        from video_stabilization.serve import pick_serving_devices

        said = []
        devs = pick_serving_devices(list(range(8)), 6, log=said.append)
        assert devs == list(range(6))
        assert len(said) == 1 and "6 of 8" in said[0] and "6, 7" in said[0]

    def test_silent_when_all_devices_are_used(self):
        from video_stabilization.serve import pick_serving_devices

        said = []
        assert pick_serving_devices(list(range(4)), 8, log=said.append) == \
            list(range(4))
        assert said == []


@pytest.mark.gpu
def test_warp_and_fast_on_gpu(gpu):
    """The output warp and FAST as compiled for the card, against the plain
    numpy references."""
    from video_stabilization.ops.fast import fast_score
    from video_stabilization.ops.reference import (
        fast_score_reference, warp_bilinear_reference,
    )
    from video_stabilization.ops.warp import warp_affine

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (90, 160, 3)).astype(np.float32)
    t = np.deg2rad(3.0)
    h = np.array([[np.cos(t), -np.sin(t), 4.5], [np.sin(t), np.cos(t), -2.0],
                  [0, 0, 1]], np.float32)
    with jax.default_device(gpu):
        out = np.asarray(jax.jit(warp_affine)(jnp.asarray(img),
                                              jnp.asarray(h), 7.0))
        gray = rng.integers(0, 255, (120, 200)).astype(np.float32)
        score = np.asarray(jax.jit(lambda g: fast_score(g, 20.0)[0])(
            jnp.asarray(gray)))
    assert np.abs(out - warp_bilinear_reference(img, h, 7.0)).max() < 0.05
    np.testing.assert_array_equal(score, fast_score_reference(gray, 20.0))
    print(json.dumps({"device": gpu.device_kind}))
