"""On-device timing and the engine's stage-timer observability.

The reference instruments its four hot kernels with rolling-average
wall-clock timers (src/stabilizer.cpp:982-1009, include/stabilizer.hpp:
461-469).  Dispatch here is asynchronous, so every measurement ends with
``jax.block_until_ready`` on the outputs: without it a host clock times
only the enqueue.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def honest_time(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn(*args)``: ``iters`` calls dispatched
    back to back, closed by one ``block_until_ready`` on the last outputs
    (calls on one device run in order, so the last one finishing means all
    have)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000.0


class StageTimer:
    """Host-side rolling-average stage timer mirroring the reference's
    printTimings categories (GFTT / LK / motion estimation / warp).

    Because the per-frame step is one fused program, per-stage on-device
    times are obtained by running the stage sub-functions standalone via
    :func:`honest_time`; at app level this timer tracks whole-step wall time
    with the same rolling-average update rule the reference uses
    (avg += (x - avg) / n, src/stabilizer.cpp:196-199).
    """

    def __init__(self) -> None:
        self._avg: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._last_print = time.perf_counter()
        self.print_interval_s = 1.0

    def record(self, stage: str, ms: float) -> None:
        n = self._count.get(stage, 0) + 1
        avg = self._avg.get(stage, 0.0)
        self._avg[stage] = avg + (ms - avg) / n
        self._count[stage] = n

    def averages(self) -> Dict[str, float]:
        return dict(self._avg)

    def maybe_print(self, out=None) -> None:
        now = time.perf_counter()
        if now - self._last_print < self.print_interval_s:
            return
        self._last_print = now
        parts = [f"{k}: {v:.2f} ms (n={self._count[k]})" for k, v in self._avg.items()]
        msg = "[timings] " + "; ".join(parts)
        print(msg, file=out)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no directory; otherwise the cache lives at ``<repo>/.jax_cache``
    (listed in .gitignore).  A fixed path matters: it is part of the key,
    so a cache that moves never hits.

    On the CPU backend the cache is left READ-ONLY: PJRT:CPU's
    ``executable.serialize()`` CHECK-aborts the whole process for some
    engine-step programs (seen at
    ``compilation_cache.put_executable_and_time``), so no CPU executable is
    ever written.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    on_cpu = jax.default_backend() == "cpu"
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", 1e9 if on_cpu else 1.0)
    return path

