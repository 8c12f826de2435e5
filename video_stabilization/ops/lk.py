"""Pyramidal sparse optical flow — correlation sweep + LK polish.

Functional equivalent of ``cv::calcOpticalFlowPyrLK`` with the reference's
parameters (window 21x21, maxLevel 3, eps 0.01, minEigThreshold 1e-4;
reference: src/stabilizer.cpp:185-195), re-architected for the hardware.

Why not a straight port: OpenCV's per-point Newton iterations re-sample a
21x21 patch of J at a *different* float position per point per iteration —
50+ gather-heavy steps.  The redesign makes the inner loop gather-free:

1. **Region extraction (the only gather, once per level).**  For each point
   a (win + 2·range)² region of J around the flow-propagated position.
2. **SSD correlation sweep on shared shifts.**  The candidate displacement
   grid is identical for every point, so each candidate shift is ONE uniform
   ``dynamic_slice`` of the whole (N, R, R) region stack — no per-point
   indexing.  A ``lax.scan`` over (2·range+1)² shifts accumulates the SSD
   surface with pure elementwise multiply-adds.
3. **Quadratic subpixel fit** (separable 3-point parabola) on the SSD
   surface around its argmin.
4. **LK Newton polish** (few iterations, finest level only by default) using
   the classic gradient formulation to reach centipixel agreement with
   OpenCV — each polish iteration costs one gather, but there are 2-3 of
   them instead of 200.

Status semantics match the reference's usage: a point is tracked iff its
template has enough texture (min eigenvalue of the structure tensor, same
threshold), it stays in bounds, and its final SSD is finite; failed lanes
keep their input location (caller filters by status,
src/stabilizer.cpp:203-208).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from video_stabilization.config import LKConfig


class LKResult(NamedTuple):
    points: jax.Array   # (N, 2) float32 tracked locations in image coords
    status: jax.Array   # (N,) bool — tracked successfully
    error: jax.Array    # (N,) float32 mean |residual| over the window


def _extract_patches(img: jax.Array, top_left: jax.Array, size: int) -> jax.Array:
    """Batched bilinear (size, size) patches at float top-left corners.

    One row-block gather + a uniform column slice per integer shift; the four
    bilinear taps come from a (size+1)² slice blended with per-point weights.
    img must be pre-padded so that all reads are in bounds.
    """
    i0 = jnp.floor(top_left)
    frac = top_left - i0                       # (N, 2) as (x, y)
    y0 = i0[:, 1].astype(jnp.int32)
    x0 = i0[:, 0].astype(jnp.int32)

    # gather size+1 full rows per point (contiguous reads), then per-point
    # column window via vmapped dynamic_slice on the small row slab
    rows = img[y0[:, None] + jnp.arange(size + 1)[None, :]]        # (N,s+1,W)
    big = jax.vmap(
        lambda slab, x: jax.lax.dynamic_slice(slab, (0, x), (size + 1, size + 1))
    )(rows, x0)

    fx = frac[:, 0][:, None, None]
    fy = frac[:, 1][:, None, None]
    return (
        (1 - fx) * (1 - fy) * big[:, :-1, :-1]
        + fx * (1 - fy) * big[:, :-1, 1:]
        + (1 - fx) * fy * big[:, 1:, :-1]
        + fx * fy * big[:, 1:, 1:]
    )


def _scharr_patches(p: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Scharr/32 gradients on the interior of (N, w+2, w+2) patches."""
    k0, k1, k2 = 3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0
    sm_rows = k0 * p[:, :-2, :] + k1 * p[:, 1:-1, :] + k2 * p[:, 2:, :]
    ix = sm_rows[:, :, 2:] - sm_rows[:, :, :-2]
    sm_cols = k0 * p[:, :, :-2] + k1 * p[:, :, 1:-1] + k2 * p[:, :, 2:]
    iy = sm_cols[:, 2:, :] - sm_cols[:, :-2, :]
    return ix, iy


def _ssd_displacement(region: jax.Array, templ: jax.Array, srange: int):
    """Integer+subpixel displacement minimizing SSD(region_window, templ).

    region: (N, win + 2·srange, win + 2·srange); templ: (N, win, win).
    Returns (disp (N,2) float32 in (dx, dy), min_ssd (N,)).
    """
    n, win = templ.shape[0], templ.shape[1]
    side = 2 * srange + 1

    # fully unrolled: every (sy, sx) window is a STATIC slice of the region,
    # so XLA fuses the whole surface into one parallel reduce — no sequential
    # scan steps (a row-scan version was loop-overhead-bound).
    # SSD(w) = ||w||² − 2<w, t> + ||t||²; ||t||² is shift-independent and
    # drops out of the argmin, halving the elementwise work.
    t2 = jnp.sum(templ * templ, axis=(1, 2), keepdims=False)   # (N,)
    rows = []
    for sy in range(side):
        strip = region[:, sy : sy + win, :]                    # (N, win, R)
        for sx in range(side):
            w = strip[:, :, sx : sx + win]
            rows.append(jnp.sum(w * (w - 2.0 * templ), axis=(1, 2)))
    surface = jnp.stack(rows, axis=1) + t2[:, None]            # (N, side²)

    best = jnp.argmin(surface, axis=1)
    by = best // side
    bx = best % side
    min_ssd = jnp.take_along_axis(surface, best[:, None], axis=1)[:, 0]

    # separable 3-point parabola around the min (clamped to the interior)
    surf2 = surface.reshape(n, side, side)
    byc = jnp.clip(by, 1, side - 2)
    bxc = jnp.clip(bx, 1, side - 2)

    def fit(a, b, c):
        denom = a - 2.0 * b + c
        denom = jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
        return jnp.clip(0.5 * (a - c) / denom, -0.5, 0.5)

    ridx = jnp.arange(n)
    cx_m = surf2[ridx, byc, bxc - 1]
    cx_0 = surf2[ridx, byc, bxc]
    cx_p = surf2[ridx, byc, bxc + 1]
    cy_m = surf2[ridx, byc - 1, bxc]
    cy_0 = surf2[ridx, byc, bxc]
    cy_p = surf2[ridx, byc + 1, bxc]
    sub_x = fit(cx_m, cx_0, cx_p)
    sub_y = fit(cy_m, cy_0, cy_p)
    # only trust the subpixel fit when the min is interior
    sub_x = jnp.where(bx == bxc, sub_x, 0.0)
    sub_y = jnp.where(by == byc, sub_y, 0.0)

    disp = jnp.stack(
        [bx.astype(jnp.float32) - srange + sub_x,
         by.astype(jnp.float32) - srange + sub_y], axis=-1
    )
    return disp, min_ssd


def lk_track(
    pyr_prev: Sequence[jax.Array],
    pyr_next: Sequence[jax.Array],
    points: jax.Array,
    mask: jax.Array,
    config: LKConfig = LKConfig(),
) -> LKResult:
    """Track (N, 2) level-0 ``points`` from pyr_prev to pyr_next.

    Dispatches on ``config.method``: "dense" (default — all-stencil dense
    block matching, ops/lk_dense.py) or "sweep" (per-point SSD sweep +
    Newton polish, this module)."""
    if config.method == "dense":
        from video_stabilization.ops.lk_dense import lk_track_dense

        return lk_track_dense(pyr_prev, pyr_next, points, mask, config)
    return lk_track_sweep(pyr_prev, pyr_next, points, mask, config)


def lk_track_sweep(
    pyr_prev: Sequence[jax.Array],
    pyr_next: Sequence[jax.Array],
    points: jax.Array,
    mask: jax.Array,
    config: LKConfig = LKConfig(),
) -> LKResult:
    """Per-point SSD-sweep tracker (general scenes; see module docstring)."""
    win = config.window_size
    half = (win - 1) / 2.0
    n_levels = len(pyr_prev) - 1
    n = points.shape[0]
    srange = 4                      # per-level search range (px)
    srange_top = 8                  # wider sweep at the coarsest level
    polish_iters = 3
    eps2 = config.epsilon * config.epsilon
    # cv2exact: no SSD sweep, zero-init Newton descent with OpenCV's full
    # iteration schedule at EVERY level (calcOpticalFlowPyrLK semantics,
    # reference params src/stabilizer.cpp:185-190) — the fidelity referee.
    cv2exact = config.method == "cv2exact"

    points = points.astype(jnp.float32)
    valid = mask.astype(bool)

    # Pad every level so regions/windows may overhang the image (matches
    # cv::buildOpticalFlowPyramid's reflected winSize border).  cv2exact
    # needs win+2: cv2 tracks windows overhanging by up to winSize
    # (lkpyramid.cpp bounds-checks iprevPt against [-winSize, cols)).
    pad = (win + 2) if cv2exact else (int(half) + srange_top + 3)
    pyr_prev_raw = pyr_prev
    pyr_prev = [jnp.pad(p, pad, mode="reflect") for p in pyr_prev]
    pyr_next = [jnp.pad(p, pad, mode="reflect") for p in pyr_next]

    g = jnp.zeros((n, 2), jnp.float32)
    status = valid
    err = jnp.zeros((n,), jnp.float32)
    min_eig_ok = valid

    for level in range(n_levels, -1, -1):
        img_i = pyr_prev[level]
        img_j = pyr_next[level]
        h_l = img_i.shape[0] - 2 * pad
        w_l = img_i.shape[1] - 2 * pad
        p_l = points / (2.0 ** level)
        rng = srange_top if level == n_levels else srange

        # template patches + structure tensor (win+2 for gradients)
        if cv2exact:
            # cv2 computes Scharr derivatives on the UNPADDED level and
            # zero-pads them (buildOpticalFlowPyramid: image border is
            # REFLECT_101, derivative border is BORDER_CONSTANT zero —
            # lkpyramid.cpp copyMakeBorder of derivIBuf).  Deriving from a
            # reflect-padded patch instead flips the flow of border points
            # by up to ~1 px — the dominant drift-vs-reference tail.
            from video_stabilization.ops.gradients import scharr_xy

            ix_map, iy_map = scharr_xy(pyr_prev_raw[level])
            ix_map = jnp.pad(ix_map, pad)                  # zeros outside
            iy_map = jnp.pad(iy_map, pad)
            tl_p = p_l - half + pad
            ipatch = _extract_patches(img_i, tl_p, win)
            ix = _extract_patches(ix_map, tl_p, win)
            iy = _extract_patches(iy_map, tl_p, win)
        else:
            tl_i = p_l - (half + 1.0) + pad
            ipatch_big = _extract_patches(img_i, tl_i, win + 2)
            ix, iy = _scharr_patches(ipatch_big)
            ipatch = ipatch_big[:, 1:-1, 1:-1]

        gxx = jnp.sum(ix * ix, axis=(1, 2))
        gxy = jnp.sum(ix * iy, axis=(1, 2))
        gyy = jnp.sum(iy * iy, axis=(1, 2))
        det = gxx * gyy - gxy * gxy
        if cv2exact:
            # cv2's A matrix carries raw 3/10/3 Scharr ints x FLT_SCALE
            # (1/2^20); scharr_xy is /32-normalized, so A_cv = g/1024.  The
            # minEigThreshold and D >= FLT_EPSILON gates compare in THAT
            # scale (lkpyramid.cpp:345-358).
            flt = 1.0 / 1024.0
            min_eig = (0.5 * (gxx + gyy)
                       - jnp.sqrt(jnp.square(0.5 * (gxx - gyy)) + gxy * gxy)
                       ) * flt / (win * win)
            det_cv = det * flt * flt
            good_tensor = ((min_eig >= config.min_eig_threshold)
                           & (det_cv >= jnp.float32(1.1920929e-07)))
        else:
            min_eig = (0.5 * (gxx + gyy)
                       - jnp.sqrt(jnp.square(0.5 * (gxx - gyy)) + gxy * gxy)) / (win * win)
            good_tensor = (min_eig > config.min_eig_threshold) & (det > 1e-12)

        if cv2exact:
            # cv2 loses a point only when the window floor leaves
            # [-winSize, cols) x [-winSize, rows) — windows may overhang
            # the image by up to winSize (template AND tracked window)
            ifl_i = jnp.floor(p_l - half)
            ifl_j = jnp.floor(p_l + g - half)
            def _inb(ifl):
                return ((ifl[:, 0] >= -win) & (ifl[:, 0] < w_l)
                        & (ifl[:, 1] >= -win) & (ifl[:, 1] < h_l))
            in_bounds = _inb(ifl_i) & _inb(ifl_j)
        else:
            in_bounds = (
                (p_l[:, 0] >= 0.0) & (p_l[:, 1] >= 0.0)
                & (p_l[:, 0] <= w_l - 1.0) & (p_l[:, 1] <= h_l - 1.0)
            )
        level_ok = status & good_tensor & in_bounds
        if level == n_levels:
            min_eig_ok = good_tensor

        # --- SSD sweep over shared integer shifts ---------------------------
        # Skipped at the finest level: the coarse levels localize the flow to
        # within ~1 px there, squarely inside the Newton polish's basin —
        # saving the most expensive region extraction + surface sweep.
        if level > 0 and not cv2exact:
            tl_j = p_l + g - (half + rng) + pad
            region = _extract_patches(img_j, tl_j, win + 2 * rng)
            disp, _ = _ssd_displacement(region, ipatch, rng)
            v = jnp.where(level_ok[:, None], disp, 0.0)
        else:
            v = jnp.zeros_like(g)

        # --- LK Newton polish (finest level only; every level in cv2exact) --
        if level == 0 or cv2exact:
            det_safe = jnp.where(good_tensor, det, 1.0)
            inv00 = gyy / det_safe
            inv01 = -gxy / det_safe
            inv11 = gxx / det_safe

            def polish(carry, _):
                v_cur, done, err_prev, prev_delta = carry
                tl = p_l + g + v_cur - half + pad
                jpatch = _extract_patches(img_j, tl, win)
                r = jpatch - ipatch
                bx = jnp.sum(r * ix, axis=(1, 2))
                by = jnp.sum(r * iy, axis=(1, 2))
                dx = -(inv00 * bx + inv01 * by)
                dy = -(inv01 * bx + inv11 * by)
                delta = jnp.stack([dx, dy], axis=-1)
                act = level_ok & ~done
                if cv2exact:
                    # cv2's oscillation exit (lkpyramid.cpp:550-556): when
                    # two consecutive deltas nearly cancel, take back half
                    # the last step and stop
                    osc = (jnp.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01) \
                        & (jnp.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
                    step = jnp.where((act & osc)[:, None], 0.5 * delta, delta)
                    v_new = v_cur + jnp.where(act[:, None], step, 0.0)
                    small = jnp.sum(delta * delta, axis=-1) <= eps2
                    done_new = done | small | osc
                else:
                    v_new = v_cur + jnp.where(act[:, None], delta, 0.0)
                    small = jnp.sum(delta * delta, axis=-1) < eps2
                    done_new = done | small
                err_new = jnp.mean(jnp.abs(r), axis=(1, 2))
                err_out = jnp.where(done, err_prev, err_new)
                return (v_new, done_new, err_out, delta), None

            # prev_delta init = +inf so the first iteration can't trip the
            # oscillation test (cv2 guards it with j > 0)
            pd0 = jnp.full((n, 2), jnp.inf, jnp.float32)
            (v, _, err, _), _ = jax.lax.scan(
                polish, (v, ~level_ok, err, pd0), None,
                length=config.max_iters if cv2exact else polish_iters,
            )

        g = (2.0 * (g + v)) if level > 0 else (g + v)
        status = level_ok if level == 0 else status

    new_pts = points + g
    if cv2exact:
        # cv2 does NOT invalidate points that drift (partially) outside the
        # image — only windows fully beyond the winSize border are lost,
        # which the per-level in_bounds already enforced; and it reports the
        # tracked endpoint regardless of status
        return LKResult(points=new_pts, status=status, error=err)
    h0 = pyr_prev[0].shape[0] - 2 * pad
    w0 = pyr_prev[0].shape[1] - 2 * pad
    in_final = (
        (new_pts[:, 0] >= 0.0) & (new_pts[:, 1] >= 0.0)
        & (new_pts[:, 0] < w0) & (new_pts[:, 1] < h0)
    )
    status = status & in_final & min_eig_ok
    out_pts = jnp.where(status[:, None], new_pts, points)
    return LKResult(points=out_pts, status=status, error=err)
