"""ORB detect + describe — multi-scale FAST + oriented BRIEF, fixed shapes.

Equivalent of cv::ORB with the reference's hyperparameters
(src/stabilizer.cpp:483-493): 2500-feature budget, scaleFactor 1.2, 12
levels, edgeThreshold 31, WTA_K 2, FAST_SCORE, patchSize 31, FAST
threshold 20.

Design:
- The 12-level scale pyramid has **static per-level shapes** (computed at
  trace time) and a static per-level feature budget proportional to level
  area, like cv::ORB's nfeatures-per-level split.
- FAST + 3x3 NMS + top-k per level are batched map operations (ops/fast.py).
- Orientation is the intensity-centroid angle over the circular 31-patch.
- Descriptors are **steered BRIEF** over OpenCV's learned 256-pair test
  pattern by default (bit_pattern_31_, recovered bit-exactly from the cv2
  binary into ops/orb_pattern.py; ``ORBConfig.pattern="brief"`` selects the
  original seeded-Gaussian construction instead), rotated by the keypoint
  angle, sampled with nearest-neighbor lookups from a 7x7-Gauss-blurred
  level image.  Bits are stored as +-1 int8 so Hamming distance becomes one
  bf16 matmul on the MXU (ops/match.py).
- Output is a fixed-capacity feature set with a validity mask; keypoint
  coordinates/sizes are mapped back to level-0 pixels (size = 31·1.2^level,
  used by the relative-size filter, src/stabilizer.cpp:290-309).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from video_stabilization.config import ORBConfig
from video_stabilization.ops.fast import fast_score
from video_stabilization.ops.image import resize_bilinear
from video_stabilization.ops.pyramid import _reflect101_pad

PATCH_RADIUS = 15          # patchSize 31
_EXTRACT_RADIUS = 24       # covers rotated BRIEF reach (15·√2 ≈ 21.2)
_EXTRACT = 2 * _EXTRACT_RADIUS + 1

# --- deterministic BRIEF test pattern (256 pairs, Gaussian σ = patch/5) -----
_rng = np.random.default_rng(20240816)
_P1 = np.clip(np.round(_rng.normal(0.0, PATCH_RADIUS / 2.0, (256, 2))), -15, 15)
_P2 = np.clip(np.round(_rng.normal(0.0, PATCH_RADIUS / 2.0, (256, 2))), -15, 15)
# Host (numpy) constants — see ops/pyramid.py note on device-array globals.
BRIEF_PATTERN_1 = np.asarray(_P1, np.float32)   # (256, 2) as (x, y)
BRIEF_PATTERN_2 = np.asarray(_P2, np.float32)

# circular mask for the intensity centroid (31x31)
_yy, _xx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
_CIRC = (_yy ** 2 + _xx ** 2) <= PATCH_RADIUS ** 2
CENTROID_MASK = np.asarray(_CIRC, np.float32)
CENTROID_X = np.asarray(_xx * _CIRC, np.float32)
CENTROID_Y = np.asarray(_yy * _CIRC, np.float32)

# --- quantized steering (ORB paper §4.1 discretizes the steering angle;
# the paper uses 2π/30 — we use 2π/72 so the worst-case sample displacement
# at the pattern extremes stays under 1 px, which measurably improves
# ref-vs-current descriptor stability when a keypoint's angle sits near a
# bin boundary).  Per bin, the rotated+rounded pattern as linear indices
# into the flattened (EXTRACT x EXTRACT) patch.  Host numpy: B x 256 int32.
N_ANGLE_BINS = 72


def _steered_lin(pattern: np.ndarray) -> np.ndarray:
    """Rotated+rounded pattern per bin, as linear indices into the flattened
    patch.  Bins b = m + 18k are constructed as EXACT 90-degree-k rotations
    of residual bin m, so the descriptor sampler can factor the steering
    into rot90(patch, k) x an 18-bin pattern table with bit-identical
    results (see _orient_and_describe)."""
    out = np.zeros((N_ANGLE_BINS, pattern.shape[0]), np.int32)
    n_res = N_ANGLE_BINS // 4
    for b in range(n_res):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(a), np.sin(a)
        rx = np.clip(np.round(c * pattern[:, 0] - s * pattern[:, 1]),
                     -_EXTRACT_RADIUS, _EXTRACT_RADIUS).astype(np.int32)
        ry = np.clip(np.round(s * pattern[:, 0] + c * pattern[:, 1]),
                     -_EXTRACT_RADIUS, _EXTRACT_RADIUS).astype(np.int32)
        x, y = rx, ry
        for k in range(4):
            out[b + n_res * k] = (
                (y + _EXTRACT_RADIUS) * _EXTRACT + (x + _EXTRACT_RADIUS)
            )
            x, y = -y, x                      # exact 90-degree rotation
    return out


STEERED_LIN_1 = _steered_lin(BRIEF_PATTERN_1)   # (N_ANGLE_BINS, 256)
STEERED_LIN_2 = _steered_lin(BRIEF_PATTERN_2)


import functools


@functools.lru_cache(maxsize=4)
def _pattern_tables(name: str):
    """Resolve a BRIEF test-pair table to its steered linear-index tables.

    "cv2": OpenCV's learned 256-pair pattern (orb.cpp bit_pattern_31_),
    recovered bit-exactly from the installed cv2 binary by
    benchmarks/extract_orb_pattern.py (the reference uses it via cv::ORB,
    src/stabilizer.cpp:483-493).  "brief": the seeded-Gaussian construction
    above (kept for determinism without the extracted table).
    """
    if name == "cv2":
        from video_stabilization.ops.orb_pattern import (
            CV2_ORB_P0, CV2_ORB_P1,
        )

        return _steered_lin(CV2_ORB_P0), _steered_lin(CV2_ORB_P1)
    if name == "brief":
        return STEERED_LIN_1, STEERED_LIN_2
    raise ValueError(f"unknown ORB pattern {name!r} (use 'cv2' or 'brief')")


def _fix_capacity(feats: "ORBFeatures", cap: int) -> "ORBFeatures":
    """Pad or top-k-truncate to exactly ``cap`` keypoint slots so the output
    shape is independent of how many pyramid levels fit the image (small
    frames break out of the level loop early)."""
    n = feats.points.shape[0]
    if n == cap:
        return feats
    if n < cap:
        pad = cap - n
        return ORBFeatures(
            points=jnp.pad(feats.points, ((0, pad), (0, 0))),
            angle=jnp.pad(feats.angle, (0, pad)),
            response=jnp.pad(feats.response, (0, pad)),
            size=jnp.pad(feats.size, (0, pad)),
            desc=jnp.pad(feats.desc, ((0, pad), (0, 0))),
            mask=jnp.pad(feats.mask, (0, pad)),
        )
    score = jnp.where(feats.mask, feats.response, -jnp.inf)
    _, idx = jax.lax.top_k(score, cap)
    return ORBFeatures(
        points=feats.points[idx],
        angle=feats.angle[idx],
        response=feats.response[idx],
        size=feats.size[idx],
        desc=feats.desc[idx],
        mask=feats.mask[idx],
    )


class ORBFeatures(NamedTuple):
    points: jax.Array     # (N, 2) float32, level-0 pixel coords (x, y)
    angle: jax.Array      # (N,) float32 radians
    response: jax.Array   # (N,) float32 FAST score
    size: jax.Array       # (N,) float32 keypoint diameter at level 0
    desc: jax.Array       # (N, 256) int8 in {-1, +1} (0 on masked lanes)
    mask: jax.Array       # (N,) bool


def _gauss7(img: jax.Array) -> jax.Array:
    """7-tap Gaussian (sigma 2), reflect-101 — cv::ORB blurs each level with
    GaussianBlur(7, 7, 2, 2) before sampling descriptors."""
    k = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2).astype(np.float32)
    k = k / k.sum()  # host constant (see ops/pyramid.py note)
    x = _reflect101_pad(img, 3, axis=-2)
    rows = sum(k[i] * jax.lax.slice_in_dim(x, i, i + img.shape[-2], axis=-2)
               for i in range(7))
    x = _reflect101_pad(rows, 3, axis=-1)
    return sum(k[i] * jax.lax.slice_in_dim(x, i, i + img.shape[-1], axis=-1)
               for i in range(7))


def _nms3(score: jax.Array) -> jax.Array:
    neigh = jax.lax.reduce_window(score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    return jnp.where((score >= neigh) & (score > 0), score, 0.0)


def _level_budgets(total: int, n_levels: int, scale: float) -> list[int]:
    r = 1.0 / (scale * scale)           # per-level area ratio
    weights = [r ** i for i in range(n_levels)]
    s = sum(weights)
    budgets = [max(16, int(round(total * w / s))) for w in weights]
    return budgets


def _detect_level(img: jax.Array, n_keep: int, fast_threshold: float,
                  edge: int):
    """FAST + NMS + top-k on one pyramid level.  Returns (pts, score, mask)
    in level coords."""
    score, _ = fast_score(img, fast_threshold)
    h, w = img.shape
    # zero out the edgeThreshold border (ORB needs full patches)
    valid_region = jnp.zeros((h, w), bool).at[edge:h - edge, edge:w - edge].set(
        True) if (h > 2 * edge and w > 2 * edge) else jnp.zeros((h, w), bool)
    score = jnp.where(valid_region, _nms3(score), 0.0)

    # cell-based selection: best responder per cell, then top-k over cells —
    # a top_k over H*W lanes costs a full sort of the level (~1 ms at 360p);
    # cells cut the sort 16x and spread keypoints, which helps registration
    # (same design as ops/gftt.py cell suppression).  Small levels keep
    # 2px cells so tiny working resolutions retain enough candidates.
    cell = 4 if min(h, w) >= 200 else 2
    gh, gw = -(-h // cell), -(-w // cell)
    rp = jnp.pad(score, ((0, gh * cell - h), (0, gw * cell - w)))
    cells = rp.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(
        gh, gw, cell * cell)
    best_in = jnp.argmax(cells, axis=-1)
    best_val = jnp.take_along_axis(cells, best_in[..., None], axis=-1)[..., 0]
    cy = jnp.arange(gh)[:, None] * cell + best_in // cell
    cx = jnp.arange(gw)[None, :] * cell + best_in % cell

    flat = best_val.reshape(-1)
    n_cells = flat.shape[0]
    if n_cells < n_keep:
        flat = jnp.pad(flat, (0, n_keep - n_cells))
        cy = jnp.pad(cy.reshape(-1), (0, n_keep - n_cells))
        cx = jnp.pad(cx.reshape(-1), (0, n_keep - n_cells))
    else:
        cy = cy.reshape(-1)
        cx = cx.reshape(-1)
    top, idx = jax.lax.top_k(flat, n_keep)
    ys = cy[idx].astype(jnp.float32)
    xs = cx[idx].astype(jnp.float32)
    mask = top > 0
    return jnp.stack([xs, ys], -1), top, mask


def _pattern_esel(pattern: str) -> jax.Array:
    """The (P², n_res·512) bf16 one-hot descriptor-sampling table.  Built
    ONCE per program and shared by every pyramid level (it is 17.7 MB —
    rebuilding it per level cost ~12x its traffic); the optimization_barrier
    stops XLA from constant-folding it into the executable, and keeps it
    batch-invariant under vmap (offline pipeline lanes share one table)."""
    n_res = N_ANGLE_BINS // 4
    lin1, lin2 = _pattern_tables(pattern)
    lin = jnp.concatenate(
        [jnp.asarray(lin1[:n_res]), jnp.asarray(lin2[:n_res])],
        axis=1,
    ).reshape(-1)                                    # (n_res*512,)
    return jax.lax.optimization_barrier(
        (jnp.arange(_EXTRACT * _EXTRACT)[:, None] == lin[None, :]
         ).astype(jnp.bfloat16)
    )


def _orient_and_describe(img_raw: jax.Array, img_blur: jax.Array,
                         pts: jax.Array, mask: jax.Array,
                         pattern: str = "cv2",
                         esel: jax.Array | None = None):
    """Intensity-centroid angles + steered BRIEF for keypoints on one level.

    Batched formulation instead of the naive per-point version (vmap of
    dynamic_slice + a 512-element gather per keypoint):

    1. all (EXTRACT x EXTRACT) patches at once via two one-hot matmuls
       (row-select @ image @ col-select);
    2. intensity-centroid moments as one einsum against the circular masks;
    3. steering quantized to N_ANGLE_BINS=72 orientation bins (finer than
       the ORB paper's 2π/30 increments, §4.1 — see the header note): ONE
       matmul samples every bin's rotated pattern (patch_flat @ E, E built
       in-trace from STEERED_LIN_*), then each keypoint selects its bin's
       256 columns with a masked sum.
    """
    h, w = img_raw.shape
    rad = _EXTRACT_RADIUS

    iy = jnp.clip(jnp.round(pts[:, 1]).astype(jnp.int32) - rad, 0, h - _EXTRACT)
    ix = jnp.clip(jnp.round(pts[:, 0]).astype(jnp.int32) - rad, 0, w - _EXTRACT)

    # --- patch extraction: one-hot row/col selection on the MXU -------------
    from video_stabilization.ops.patches import extract_patches_mxu

    both = jnp.stack([img_raw, img_blur])                        # (2, H, W)
    patches = extract_patches_mxu(both, iy, ix, _EXTRACT)        # (N, 2, P, P)
    return _describe_patches(patches, mask, pattern, esel)


def _describe_patches(patches: jax.Array, mask: jax.Array,
                      pattern: str = "cv2",
                      esel: jax.Array | None = None):
    """Steps 2-3 of :func:`_orient_and_describe` on pre-extracted patches —
    split out so the atlas pipeline can run ONE describe pass over every
    pyramid level's keypoints at once (extraction stays per level: the
    one-hot matmul cost scales with image height, so extracting against the
    full atlas would pay ~10x the FLOPs)."""
    n = patches.shape[0]

    # --- orientation: intensity centroid on the raw patch -------------------
    off = _EXTRACT_RADIUS - PATCH_RADIUS
    raw31 = patches[:, 0, off : off + 2 * PATCH_RADIUS + 1,
                    off : off + 2 * PATCH_RADIUS + 1]
    # full f32: TF32 moments could move an angle across a steering bin
    m10 = jnp.einsum("npq,pq->n", raw31, CENTROID_X,
                     precision=jax.lax.Precision.HIGHEST)
    m01 = jnp.einsum("npq,pq->n", raw31, CENTROID_Y,
                     precision=jax.lax.Precision.HIGHEST)
    angles = jnp.arctan2(m01, m10)
    bins = jnp.mod(
        jnp.round(angles * (N_ANGLE_BINS / (2.0 * jnp.pi))).astype(jnp.int32),
        N_ANGLE_BINS,
    )

    # --- steered BRIEF: factored rotation sampling ---------------------------
    # R(θ_b) = R90^k · R(θ_m) with b = m + 18k: the 90-degree part is an
    # EXACT integer permutation of the patch grid (rot90 commutes with the
    # round+clip of the pattern offsets), so each keypoint samples one of 4
    # patch rotations with only the 18 residual-bin patterns — the sampling
    # matmul shrinks 4x with bit-identical descriptors vs the full 72-bin
    # table (validated by tests/test_orb.py::test_factored_rotation_exact).
    n_res = N_ANGLE_BINS // 4                        # 18 residual bins
    m_bin = bins % n_res
    k_rot = bins // n_res
    p3 = patches[:, 1].reshape(n, _EXTRACT, _EXTRACT)
    sel = p3
    rot = p3
    for k in range(1, 4):
        rot = jnp.rot90(rot, 1, axes=(1, 2))
        sel = jnp.where((k_rot == k)[:, None, None], rot, sel)
    flat = sel.reshape(n, _EXTRACT * _EXTRACT).astype(jnp.bfloat16)

    if esel is None:
        esel = _pattern_esel(pattern)                # (P², n_res*512)
    sampled = jnp.matmul(flat, esel, preferred_element_type=jnp.float32)
    sampled = sampled.reshape(n, n_res, 2, 256)

    v = jnp.zeros((n, 2, 256), jnp.float32)
    for b in range(n_res):
        v = v + jnp.where((m_bin == b)[:, None, None], sampled[:, b], 0.0)

    bits = jnp.where(v[:, 0] < v[:, 1], jnp.int8(1), jnp.int8(-1))
    descs = jnp.where(mask[:, None], bits, jnp.int8(0))
    return angles, descs


def _cell_reduce(score: jax.Array, cell: int):
    """Best responder per cell on one level's score map: (n_cells,) values
    + level-local float coords (pure vector ops — no gathers; max/argmax
    replace take_along_axis)."""
    h, w = score.shape
    gh, gw = -(-h // cell), -(-w // cell)
    rp = jnp.pad(score, ((0, gh * cell - h), (0, gw * cell - w)))
    cells = rp.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(
        gh, gw, cell * cell)
    best_in = jnp.argmax(cells, axis=-1)
    best_val = jnp.max(cells, axis=-1)
    cy = jnp.arange(gh)[:, None] * cell + best_in // cell
    cx = jnp.arange(gw)[None, :] * cell + best_in % cell
    return (best_val.reshape(-1), cy.reshape(-1).astype(jnp.float32),
            cx.reshape(-1).astype(jnp.float32))


def orb_detect_and_compute(
    img: jax.Array, config: ORBConfig = ORBConfig()
) -> ORBFeatures:
    """Detect + describe on a (H, W) float32 grayscale image.

    Hybrid formulation:

    - detection per level at its EXACT shape — FAST (ops/fast.py) + NMS +
      cell top-k + the 7-tap blur + one-hot patch extraction.  Packing all
      12 levels into one tall width-padded atlas would make every level pay
      full-width FAST/NMS (~1.7x the true pixels) on a memory-bound pass;
    - ONE batched top-k over every level's cell winners and ONE describe
      pass over every level's extracted patches (the atlas round's good
      halves): the k-selection sort, the descriptor-sampling matmul, and
      the 18-bin masked sum run once instead of 12x at poor occupancy —
      selection- and descriptor-identical per keypoint (each top-k row's
      first budgets[l] entries equal the per-level top-k; describe rows
      are independent).
    """
    h, w = img.shape
    img = img.astype(jnp.float32)
    budgets = _level_budgets(config.max_features, config.n_levels,
                             config.scale_factor)
    e = config.edge_threshold

    from video_stabilization.ops.patches import extract_patches_mxu

    esel = _pattern_esel(config.pattern)    # one 17.7 MB table for ALL levels

    # ---- per-level FAST + NMS + interior mask + cell reduce (exact
    # level shapes) ----------------------------------------------------
    levels = []                       # (level_img, blur, lh, lw, scale)
    vals, cys, cxs = [], [], []
    level_img = img
    for level in range(config.n_levels):
        scale = config.scale_factor ** level
        lh, lw = level_img.shape
        if lh <= 2 * e or lw <= 2 * e:
            break
        with jax.named_scope(f"stage_orb_detect_l{level}"):
            score, _ = fast_score(level_img, config.fast_threshold)
            valid_region = (jnp.zeros((lh, lw), bool)
                            .at[e:lh - e, e:lw - e].set(True)
                            if (lh > 2 * e and lw > 2 * e)
                            else jnp.zeros((lh, lw), bool))
            score = jnp.where(valid_region, _nms3(score), 0.0)
            cell = 4 if min(lh, lw) >= 200 else 2
            v, cy, cx = _cell_reduce(score, cell)
            blur = _gauss7(level_img)
        levels.append((level_img, blur, lh, lw, scale))
        vals.append(v)
        cys.append(cy)
        cxs.append(cx)
        nh = int(round(h / (config.scale_factor ** (level + 1))))
        nw = int(round(w / (config.scale_factor ** (level + 1))))
        level_img = resize_bilinear(img, nh, nw)
    n_lv = len(levels)

    # ---- ONE batched top-k over every level's cell winners (selection-
    # equivalent to per-level top_k: each row's top budgets[l] entries are
    # the same set in the same order; zero-padded lanes mask out) --------
    with jax.named_scope("stage_orb_select"):
        k0 = max(budgets[:n_lv])
        n_max = max([k0] + [v.shape[0] for v in vals])
        stackpad = lambda xs: jnp.stack(  # noqa: E731
            [jnp.pad(x, (0, n_max - x.shape[0])) for x in xs])
        top, idx = jax.lax.top_k(stackpad(vals), k0)           # (L, k0)
        coords = jnp.stack([stackpad(cxs), stackpad(cys)], 1)  # (L, 2, n_max)
        picked = jnp.take_along_axis(coords, idx[:, None, :], axis=2)

    # ---- per-level patch extraction feeding ONE describe pass ----------
    all_pts, all_resp, all_size, all_mask, all_patches = [], [], [], [], []
    for level, (level_img, blur, lh, lw, scale) in enumerate(levels):
        nb = budgets[level]
        xs_l, ys_l = picked[level, 0, :nb], picked[level, 1, :nb]
        resp = top[level, :nb]
        mask = resp > 0
        with jax.named_scope(f"stage_orb_extract_l{level}"):
            iy = jnp.clip(
                jnp.round(ys_l).astype(jnp.int32) - _EXTRACT_RADIUS,
                0, lh - _EXTRACT)
            ix = jnp.clip(
                jnp.round(xs_l).astype(jnp.int32) - _EXTRACT_RADIUS,
                0, lw - _EXTRACT)
            all_patches.append(extract_patches_mxu(
                jnp.stack([level_img, blur]), iy, ix, _EXTRACT))

        all_pts.append(jnp.stack([xs_l, ys_l], -1) * scale)
        all_resp.append(resp)
        all_size.append(jnp.full((nb,), config.patch_size * scale))
        all_mask.append(mask)

    mask_all = jnp.concatenate(all_mask)
    with jax.named_scope("stage_orb_desc"):
        ang_all, desc_all = _describe_patches(
            jnp.concatenate(all_patches, axis=0), mask_all,
            config.pattern, esel=esel)

    feats = ORBFeatures(
        points=jnp.concatenate(all_pts, axis=0),
        angle=ang_all,
        response=jnp.concatenate(all_resp),
        size=jnp.concatenate(all_size),
        desc=desc_all,
        mask=mask_all,
    )
    feats = _fix_capacity(feats, config.max_features)
    # relative keypoint-size filter (reference: filterKeypointByRelativeSize,
    # src/stabilizer.cpp:290-309, max ratio 0.10 for ORB)
    keep = feats.size <= (h * config.max_keypoint_size_ratio)
    return feats._replace(mask=feats.mask & keep)
