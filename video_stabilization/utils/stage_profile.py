"""Per-stage device timing of the fused step, from profiler traces.

The reference prints rolling per-kernel averages from inside its loop
(printTimings, src/stabilizer.cpp:982-1009).  The engine runs the whole
frame as ONE fused XLA program, so per-stage times cannot be measured with
host clocks; instead:

1. ``stabilize_step`` wraps its stages in ``jax.named_scope("stage_*")``;
   the scopes flow into each HLO instruction's ``op_name`` metadata.
2. ``build_stage_map`` parses the *optimized* HLO of the compiled step and
   maps every top-level instruction (fusions included) to its stage.
3. ``profile_stages`` runs N live steps under ``jax.profiler.trace`` and
   ``reduce_device_trace`` sums the GPU kernel events by stage.

Device durations come from the hardware trace, so the numbers are correct
even when the host is contended — unlike wall-clock stage timing.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import tempfile
from typing import Callable, Dict, Iterable

# take the LAST (most deeply nested = most specific) stage scope on the op
_STAGE_RE = re.compile(r"op_name=\"(?:[^\"]*/)?(stage_[a-z0-9_]+)")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?(%?[\w.\-]+)\s*=")
_SCOPE_RE = re.compile(r"(?:^|/)(stage_[a-z0-9_]+)")


def build_stage_map(hlo_text: str) -> Dict[str, str]:
    """Map top-level HLO instruction names -> stage_* labels.

    Uses each instruction's own ``metadata={op_name=...}``; for fusions
    whose metadata lacks a stage, falls back to the first stage found among
    the instructions of the called fused computation.
    """
    # split into computations: "%name (args) -> ... {" blocks
    comp_stage_hits: Dict[str, str] = {}
    instr_stage: Dict[str, str] = {}
    instr_calls: Dict[str, str] = {}
    current_comp = None
    in_entry = False
    entry_name = None
    m = re.search(r"ENTRY\s+(%?[\w.\-]+)", hlo_text)
    if m:
        entry_name = m.group(1)

    for line in hlo_text.splitlines():
        comp_m = re.match(r"\s*(?:ENTRY\s+)?(%?[\w.\-]+)\s*\([^)]*\)\s*->", line)
        if comp_m and "{" in line:
            current_comp = comp_m.group(1)
            in_entry = current_comp == entry_name
            continue
        im = _INSTR_RE.match(line)
        if not im:
            continue
        name = im.group(1)
        sm = _STAGE_RE.search(line)
        if sm and current_comp is not None and current_comp not in comp_stage_hits:
            comp_stage_hits[current_comp] = sm.group(1)
        if in_entry:
            if sm:
                instr_stage[name] = sm.group(1)
            cm = re.search(r"calls=(%?[\w.\-]+)", line)
            if cm:
                instr_calls[name] = cm.group(1)

    for name, callee in instr_calls.items():
        if name not in instr_stage and callee in comp_stage_hits:
            instr_stage[name] = comp_stage_hits[callee]
    return instr_stage


_MODULE_RE = re.compile(r"^\s*HloModule\s+([\w.\-]+)", re.MULTILINE)


def _module_name(hlo_text: str) -> str | None:
    m = _MODULE_RE.search(hlo_text)
    return m.group(1) if m else None


def reduce_device_trace(
    planes: Iterable, stage_map: Dict[str, str], module: str | None = None,
) -> Dict[str, float]:
    """Per-stage device ms from profiler planes laid out as a GPU trace.

    A GPU trace has one ``/device:GPU:<n>`` plane per card and one line per
    CUDA stream (``Stream #13(Compute)``).  Each kernel event carries the
    HLO instruction it belongs to in its ``hlo_op`` stat, the program in
    ``hlo_module`` and, for most ops, the op_name scope path (``jit(step)/
    stage_lk/...``) in ``name``.  An event is attributed to the stage that
    ``stage_map`` gives its ``hlo_op``, else to the last ``stage_*`` in its
    ``name``; the rest of the module's device time is ``other``.  Events of
    other modules are left out when ``module`` is given.

    Returns {stage: ms, ..., "other": ms, "total": ms}, where the stages and
    ``other`` sum to ``total``.  Returns {} when there is no device plane
    (the CPU backend traces host threads only).  Raises RuntimeError when
    device planes exist but no event is attributed to a stage.
    """
    totals: Dict[str, float] = {}
    grand = 0.0
    attributed = 0
    n_device_planes = 0
    for plane in planes:
        if not plane.name.startswith("/device:"):
            continue
        n_device_planes += 1
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if module is not None and stats.get("hlo_module") not in (
                        None, module):
                    continue
                op = str(stats.get("hlo_op", ""))
                stage = stage_map.get(op) or stage_map.get("%" + op)
                if stage is None:
                    found = _SCOPE_RE.findall(str(stats.get("name", "")))
                    stage = found[-1] if found else None
                dur_ms = (ev.duration_ns or 0.0) / 1e6
                grand += dur_ms
                if stage is not None:
                    attributed += 1
                key = stage if stage else "other"
                totals[key] = totals.get(key, 0.0) + dur_ms
    if n_device_planes == 0:
        return {}
    if attributed == 0:
        raise RuntimeError(
            f"device trace of {n_device_planes} plane(s) has no event "
            f"attributed to a stage_* scope (module {module!r})")
    totals.setdefault("other", 0.0)
    totals["total"] = grand
    return totals


def profile_stages(
    run_steps: Callable[[], None],
    hlo_text: str,
    tmp_root: str | None = None,
    n_calls: int = 1,
) -> Dict[str, float]:
    """Trace ``run_steps()`` and return per-stage device ms per call.

    Args:
      run_steps: runs ``n_calls`` step invocations and blocks on the result.
      hlo_text: optimized HLO of the compiled step (``compiled.as_text()``).
      n_calls: how many step calls run_steps performs (for averaging).

    Returns {stage: ms_per_call}, plus "total" and "other" entries (see
    :func:`reduce_device_trace`); {} on a backend without device planes.
    """
    import jax

    stage_map = build_stage_map(hlo_text)
    tmpdir = tempfile.mkdtemp(prefix="stageprof_", dir=tmp_root)
    try:
        with jax.profiler.trace(tmpdir):
            run_steps()
        files = glob.glob(
            os.path.join(tmpdir, "**", "*.xplane.pb"), recursive=True
        )
        if not files:
            return {}
        pd = jax.profiler.ProfileData.from_file(files[0])
        totals = reduce_device_trace(pd.planes, stage_map,
                                     _module_name(hlo_text))
        return {k: v / max(n_calls, 1) for k, v in totals.items()}
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def device_ms_per_call(
    run_calls: Callable[[], None], n_calls: int = 1,
    tmp_root: str | None = None,
) -> float | None:
    """Trace ``run_calls()`` (which makes ``n_calls`` calls and blocks on
    the result) and return the summed duration of every kernel event on the
    device planes, per call.  None when the trace has no device plane (the
    CPU backend)."""
    import jax

    tmpdir = tempfile.mkdtemp(prefix="devms_", dir=tmp_root)
    try:
        with jax.profiler.trace(tmpdir):
            run_calls()
        files = glob.glob(
            os.path.join(tmpdir, "**", "*.xplane.pb"), recursive=True)
        if not files:
            return None
        pd = jax.profiler.ProfileData.from_file(files[0])
        planes = [p for p in pd.planes if p.name.startswith("/device:")]
        if not planes:
            return None
        ns = sum(ev.duration_ns or 0.0 for p in planes for line in p.lines
                 for ev in line.events)
        return ns / 1e6 / max(n_calls, 1)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


# reference printTimings categories mapping (src/stabilizer.cpp:982-1009)
REFERENCE_STAGE_LABELS = {
    "stage_gftt": "goodFeaturesToTrack",
    "stage_lk": "calcOpticalFlowPyrLK",
    "stage_fit": "estimateAffinePartial2D",
    "stage_warp": "warpPerspective",
    "stage_gray_pyramid": "resize+cvtColor+pyramid",
    "stage_smoothing": "smoothing window",
    "stage_lock": "lock transform",
}


def format_stage_report(stage_ms: Dict[str, float]) -> str:
    """One-line printTimings-style report from a profile_stages result.
    Sub-scopes (e.g. stage_lk_l3) aggregate into their parent category."""
    parts = []
    for key, label in REFERENCE_STAGE_LABELS.items():
        ms = sum(v for k, v in stage_ms.items() if k.startswith(key))
        if ms > 0.0:
            parts.append(f"{label}: {ms:.2f} ms")
    other = stage_ms.get("other", 0.0)
    total = stage_ms.get("total", 0.0)
    parts.append(f"other: {other:.2f} ms")
    parts.append(f"device total: {total:.2f} ms")
    return " | ".join(parts)
