"""Dense block-matching pyramidal optical flow — the all-stencil LK redesign.

Functional equivalent of ``cv::calcOpticalFlowPyrLK`` with the reference's
parameters (window 21x21, maxLevel 3; reference src/stabilizer.cpp:185-195),
architected so the hot loop contains ZERO per-point gathers:

1. **Coarse dense search.**  At the coarsest pyramid level, a dense SSD
   block-matching sweep over shared integer shifts: every shift is one static
   slice of the whole level, the 21x21 SSD aggregation is a cumsum box
   filter, and ``SSD = box(J_s²) - 2·box(J_s·I) + box(I²)`` reuses a single
   ``box(J²)`` map for all shifts (integer shifts commute with the box).
2. **Global-motion chaining.**  Inter-frame motion in stabilization is a
   global similarity (the engine immediately RANSAC-fits one anyway).  At
   each finer level the next frame is warped by the current similarity
   estimate (one affine warp — rotation removed, so small residual
   search ranges suffice) and the dense residual flow re-fits the similarity
   on a regular pixel grid via IRLS: grid samples are strided slices, not
   gathers.
3. **Dense Newton polish.**  At the finest level, two classic LK Newton
   rounds computed densely (Scharr gradients + box-filtered structure
   tensor and residual moments — all stencils), each followed by a refit
   and re-warp.
4. **One tiny sample.**  The per-point answer is a bilinear sample of the
   final dense maps at the query corners — the only gather, ~1300 x 4 taps.

Status semantics: tracked iff the template has texture (min eigenvalue of
the 21x21 structure tensor over Scharr/32 gradients, threshold
``min_eig_threshold``), the endpoint stays in bounds, and the residual is
finite.  **Independent motion caveat**: the dense chain estimates ONE global
similarity, so points on independently moving objects are *snapped onto the
global motion* — unlike the reference's per-point LK they would come back as
perfect inliers, silently moving outlier rejection out of RANSAC.  Two
gates restore per-point semantics: (a) points whose sampled final-round
dense delta exceeds a 1.5 px trust radius are dropped (after two Newton
rounds a global-motion point has near-zero residual delta; a large one
means the point's true motion differs from the global similarity — a
moving object; with ``corner_polish_iters > 0`` the per-point polish adds
its saturating-step test on top), and (b) points whose sampled patch
residual is far above the valid-point cohort's median are dropped
(large-but-sub-clip independent motion and occlusions).  Points moving
within ~1 px of the global motion remain inliers; for true per-point
tracking of general dynamic scenes use ``LKConfig(method="sweep")``.

"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from video_stabilization.config import LKConfig
from video_stabilization.motion.similarity import fit_similarity_masked
from video_stabilization.ops.gradients import scharr_xy
from video_stabilization.ops.warp import _inv3x3, warp_affine

_HIGH = jax.lax.Precision.HIGHEST


def _band(n: int, win: int) -> jax.Array:
    """(n, n) bf16 banded-ones matrix: band[i, j] = 1 iff j is inside the
    length-``win`` window centered (win//2 left taps) at i — multiplying by
    it computes a zero-padded SAME box sum along that axis."""
    h = win // 2
    i = jnp.arange(n)[:, None]
    j = jnp.arange(n)[None, :]
    return ((j >= i - h) & (j <= i - h + win - 1)).astype(jnp.bfloat16)


def _box_same(x: jax.Array, win: int) -> jax.Array:
    """win x win box sum, zero-padded SAME, as two banded-ones matmuls.

    A box filter is a matmul with a banded all-ones matrix per axis — the
    aggregation runs as a bf16 matrix product with f32 accumulation.  A
    cumsum formulation is O(1) FLOPs per pixel where this one is O(win);
    which is faster on the GPU is not measured yet.  Inputs round to bf16: the
    band is exact 0/1 and the 0.4% element rounding averages out over the
    441-tap window (measured: no corner-drift change at 1e-3 px resolution).
    """
    hgt, wid = x.shape[-2], x.shape[-1]
    t = jnp.einsum(
        "ij,...jw->...iw", _band(hgt, win), x.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return jnp.einsum(
        "...iw,wk->...ik", t.astype(jnp.bfloat16), _band(wid, win).T,
        preferred_element_type=jnp.float32,
    )


def _dense_residual_flow(
    img_i: jax.Array, img_j: jax.Array, srange: int, win: int
) -> Tuple[jax.Array, jax.Array]:
    """Dense integer+parabola flow minimizing the win x win SSD between
    ``img_j`` shifted by the flow and ``img_i``.

    Returns (flow (H, W, 2) as (dx, dy), interior (H, W) bool — False where
    the argmin sits on the search boundary).
    """
    h, w = img_i.shape
    side = 2 * srange + 1
    jp = jnp.pad(img_j, srange)

    # Stack ALL side² shifted frames and box-filter the SQUARED DIFFERENCE
    # stack with one banded-matmul pair.  The round-3 expansion
    # ``box(J²) − 2·box(J·I) + box(I²)`` reused one box(J²) map across
    # shifts, but it cancels catastrophically under the bf16 MXU box filter
    # (each term ~3e7 with value-relative rounding → ±2e5 error swamping the
    # ~3e4 inter-shift SSD signal on smooth regions, sending the argmin
    # random).  Boxing (J_s − I)² directly is cancellation-free — errors are
    # relative to the local SSD itself, and a perfect match is an exact 0 —
    # and it is also cheaper: one stacked box filter instead of box(cross)
    # stacked + box(J²) + box(I²).
    shifted = jnp.stack([
        jax.lax.slice(jp, (sy, sx), (sy + h, sx + w))
        for sy in range(side) for sx in range(side)
    ])                                       # (side², H, W)
    surf = _box_same(jnp.square(shifted - img_i[None]), win)

    amin = jnp.argmin(surf, axis=0)
    ay = amin // side
    ax = amin % side
    ayc = jnp.clip(ay, 1, side - 2)
    axc = jnp.clip(ax, 1, side - 2)

    karange = jnp.arange(side * side, dtype=jnp.int32)[:, None, None]

    def pick(dy, dx):
        # one-hot reduction over the stacked axis (single fused op, vs the
        # round-2 side²-iteration where-accumulate chain)
        idx = (ayc + dy) * side + (axc + dx)
        return jnp.sum(jnp.where(idx[None] == karange, surf, 0.0), axis=0)

    c0 = pick(0, 0)
    cxm, cxp = pick(0, -1), pick(0, 1)
    cym, cyp = pick(-1, 0), pick(1, 0)

    def fit(a, b, c):
        denom = a - 2.0 * b + c
        denom = jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
        return jnp.clip(0.5 * (a - c) / denom, -0.5, 0.5)

    sub_x = jnp.where(ax == axc, fit(cxm, c0, cxp), 0.0)
    sub_y = jnp.where(ay == ayc, fit(cym, c0, cyp), 0.0)
    flow = jnp.stack(
        [ax.astype(jnp.float32) - srange + sub_x,
         ay.astype(jnp.float32) - srange + sub_y], axis=-1
    )
    interior = (ax > 0) & (ax < side - 1) & (ay > 0) & (ay < side - 1)
    return flow, interior


def _min_eig_dense(ix: jax.Array, iy: jax.Array, win: int) -> jax.Array:
    """Per-pixel smaller structure-tensor eigenvalue over a win x win window
    of Scharr/32 gradients, normalized by win² (cv2 LK minEig convention)."""
    gxx = _box_same(ix * ix, win)
    gxy = _box_same(ix * iy, win)
    gyy = _box_same(iy * iy, win)
    half_tr = 0.5 * (gxx + gyy)
    disc = jnp.sqrt(jnp.square(0.5 * (gxx - gyy)) + jnp.square(gxy))
    return (half_tr - disc) / float(win * win)


def _apply_h(h: jax.Array, pts: jax.Array) -> jax.Array:
    """Affine 3x3 applied to (..., 2) points (no projective divide)."""
    return jnp.matmul(pts, h[:2, :2].T, precision=_HIGH) + h[:2, 2]


def _scale_h(h: jax.Array, s: float) -> jax.Array:
    """Similarity h at level-0 coords -> coords scaled by 1/s (level l with
    s = 2^l): U⁻¹ h U, which only rescales the translation."""
    return h.at[:2, 2].set(h[:2, 2] / s)


def _grid_fit(
    h_cur: jax.Array,
    flow: jax.Array,
    interior: jax.Array,
    min_eig: jax.Array,
    scale: float,
    min_eig_threshold: float,
    resid_px: float,
    vote_range: int = 9,
) -> jax.Array:
    """IRLS similarity refit from a dense residual flow on a regular grid.

    Grid samples are strided slices (no gathers).  Correspondence model:
    position in J = h_cur·(x + flow(x)) at this level; the fit is performed
    in level-0 coordinates.  Returns the updated level-0 similarity.
    """
    hgt, wid = flow.shape[:2]
    stride = max(4, min(hgt, wid) // 22)
    off = stride // 2
    sl = (slice(off, None, stride), slice(off, None, stride))

    ys = jnp.arange(off, hgt, stride, dtype=jnp.float32)
    xs = jnp.arange(off, wid, stride, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys)
    src_l = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)          # level px

    # keep grid points whose SSD windows never touched the zero padding
    margin = 10.0
    in_core = (
        (src_l[:, 0] >= margin) & (src_l[:, 0] < wid - margin)
        & (src_l[:, 1] >= margin) & (src_l[:, 1] < hgt - margin)
    )

    f = flow[sl].reshape(-1, 2)
    w0 = (
        interior[sl].reshape(-1)
        & in_core
        & (min_eig[sl].reshape(-1) > min_eig_threshold)
    )

    # Robust init: gate around the plurality flow before any LS fit —
    # border/flat cells report ~zero flow and a plain LS fit absorbs them
    # (measured: 25% zero-flow outliers bias tx by 25%).  The center is a
    # per-component histogram mode (unit-width votes over the search range):
    # O(range x grid) selects instead of the sort a median would cost.
    wf = w0.astype(jnp.float32)
    bins = jnp.arange(-vote_range, vote_range + 1, dtype=jnp.float32)
    votes = jnp.sum(
        wf[None, :, None] * (jnp.abs(f[None, :, :] - bins[:, None, None]) < 1.0),
        axis=1,
    )                                                           # (B, 2)
    med = bins[jnp.argmax(votes, axis=0)]                       # (2,)
    gate = jnp.maximum(1.8, 0.25 * jnp.linalg.norm(med))
    w_med = (
        w0 & (jnp.linalg.norm(f - med, axis=-1) < gate)
    ).astype(jnp.float32)

    hl = _scale_h(h_cur, scale)
    dst_l = _apply_h(hl, src_l + f)
    src0 = src_l * scale
    dst0 = dst_l * scale

    h1, ok1 = fit_similarity_masked(src0, dst0, w_med)
    h1 = jnp.where(ok1, h1, h_cur)
    r = jnp.linalg.norm(_apply_h(h1, src0) - dst0, axis=-1)
    w1 = w_med * (r < resid_px * scale).astype(jnp.float32)
    h2, ok2 = fit_similarity_masked(src0, dst0, w1)
    return jnp.where(ok2, h2, h1)


def _extract_bilinear_mxu(img: jax.Array, top_left: jax.Array, size: int) -> jax.Array:
    """Batched bilinear (size, size) patches at float top-left corners via
    one-hot MXU extraction (ops/patches.py) + in-patch lerp.

    The lk.py ``_extract_patches`` row-gather version moves N·(size+1) full
    image rows through a gather (~76 MB for 1280 corners at 360p) and was
    the dominant LK cost (2.1 ms profiled); two selection matmuls do the
    same job in ~0.1 ms.  ``img`` must be pre-padded so reads are in bounds.
    """
    from video_stabilization.ops.patches import extract_patches_mxu

    h, w = img.shape
    i0 = jnp.floor(top_left)
    frac = top_left - i0                        # (N, 2) as (x, y)
    y0 = jnp.clip(i0[:, 1].astype(jnp.int32), 0, h - (size + 1))
    x0 = jnp.clip(i0[:, 0].astype(jnp.int32), 0, w - (size + 1))
    big = extract_patches_mxu(img[None], y0, x0, size + 1)[:, 0]
    fx = frac[:, 0][:, None, None]
    fy = frac[:, 1][:, None, None]
    return (
        (1 - fx) * (1 - fy) * big[:, :-1, :-1]
        + fx * (1 - fy) * big[:, :-1, 1:]
        + (1 - fx) * fy * big[:, 1:, :-1]
        + fx * fy * big[:, 1:, 1:]
    )


def _sample_maps(maps: jax.Array, pts: jax.Array) -> jax.Array:
    """Bilinear sample of (K, H, W) maps at (N, 2) points -> (K, N).
    The dense design's single gather."""
    k, h, w = maps.shape
    flat = maps.reshape(k, h * w)
    x = jnp.clip(pts[:, 0], 0.0, w - 1.001)
    y = jnp.clip(pts[:, 1], 0.0, h - 1.001)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[None]
    fy = (y - y0)[None]
    xi = x0.astype(jnp.int32)
    yi = y0.astype(jnp.int32)

    def tap(dy, dx):
        idx = (yi + dy) * w + (xi + dx)
        return jnp.take(flat, idx, axis=1)

    return (
        tap(0, 0) * (1 - fx) * (1 - fy) + tap(0, 1) * fx * (1 - fy)
        + tap(1, 0) * (1 - fx) * fy + tap(1, 1) * fx * fy
    )


def lk_track_dense(
    pyr_prev: Sequence[jax.Array],
    pyr_next: Sequence[jax.Array],
    points: jax.Array,
    mask: jax.Array,
    config: LKConfig = LKConfig(),
):
    """Track (N, 2) level-0 ``points`` from pyr_prev to pyr_next; see module
    docstring.  Returns an ``LKResult`` (import-free duck type to avoid a
    circular import; the public entry is ``ops.lk.lk_track``)."""
    from video_stabilization.ops.lk import LKResult

    win = config.window_size
    n_levels = len(pyr_prev) - 1
    points = points.astype(jnp.float32)
    valid = mask.astype(bool)
    h0, w0 = pyr_prev[0].shape

    t_cur = jnp.eye(3, dtype=jnp.float32)

    # ---- coarse sweep ONLY at the top level -------------------------------
    # The (2r+1)² shifted SAD/box stacks are the dense design's one
    # memory-heavy construct: at 360p level 1 they were ~80 MB of stack
    # traffic per frame.  They are only *needed* where the motion is
    # unknown — the coarsest level.  Finer levels start within ~1 px of the
    # truth after the coarse similarity fit (level-l error = coarse fit
    # error x 2^(n-l), and the grid fit is sub-0.5 px at the coarse level),
    # which is deep inside the 21x21 Newton basin — so levels n-1..1 use one
    # dense Newton round (pure stencils, ~12 level-sized maps instead of
    # ~6 stack-sized ones) + the same grid refit.
    with jax.named_scope(f"stage_lk_l{n_levels}"):
        img_i = pyr_prev[n_levels]
        img_j = pyr_next[n_levels]
        scale = float(2 ** n_levels)
        rng = max(2, min(8, min(img_i.shape) // 4))
        flow, interior = _dense_residual_flow(img_i, img_j, rng, win)
        ix, iy = scharr_xy(img_i)
        me = _min_eig_dense(ix, iy, win)
        t_cur = _grid_fit(
            t_cur, flow, interior, me, scale,
            config.min_eig_threshold, resid_px=max(1.5, rng / 2.0),
            vote_range=rng + 1,
        )

    # ---- mid levels: warp + residual estimate + grid refit ------------------
    # The FIRST mid level (n-1) uses a small +-3 dense residual sweep instead
    # of a Newton round: if the coarse-level similarity fit failed (low
    # texture at the tiny top level -> identity carried down), Newton can only
    # recover motion inside its basin, while the sweep recovers up to
    # +-3*2^(n-1) px regardless of image smoothness (round-3 advisor
    # robustness finding).  It runs unconditionally — a lax.cond gate would
    # execute both branches under the offline/stream vmaps anyway, and the
    # sweep costs ~0.1 ms/chunk at 360p.  Deeper mid levels start well inside
    # the Newton basin and keep the cheap Newton round.
    for level in range(n_levels - 1, 0, -1):
        with jax.named_scope(f"stage_lk_l{level}"):
            img_i = pyr_prev[level]
            img_j = pyr_next[level]
            scale = float(2 ** level)
            ix, iy = scharr_xy(img_i)
            me = _min_eig_dense(ix, iy, win)
            hl = _scale_h(t_cur, scale)
            j_w = warp_affine(
                img_j, _inv3x3(hl), border_value=0.0)
            if level == n_levels - 1:
                delta, ok = _dense_residual_flow(img_i, j_w, 3, win)
                ok = ok & (me > config.min_eig_threshold)
                vote_range = 4
            else:
                gxx = _box_same(ix * ix, win)
                gxy = _box_same(ix * iy, win)
                gyy = _box_same(iy * iy, win)
                det = gxx * gyy - gxy * gxy
                ok = (me > config.min_eig_threshold) & (det > 1e-12)
                det_safe = jnp.where(ok, det, 1.0)
                r = j_w - img_i
                bx = _box_same(r * ix, win)
                by = _box_same(r * iy, win)
                dx = -(gyy * bx - gxy * by) / det_safe
                dy = -(gxx * by - gxy * bx) / det_safe
                delta = jnp.where(
                    ok[..., None], jnp.stack([dx, dy], axis=-1), 0.0)
                vote_range = 3
            t_cur = _grid_fit(
                t_cur, delta, ok, me, scale,
                config.min_eig_threshold, resid_px=2.0,
                vote_range=vote_range,
            )

    # ---- level-0: two dense Newton rounds with refit between ---------------
    with jax.named_scope("stage_lk_newton"):
        img_i = pyr_prev[0]
        img_j = pyr_next[0]
        ix, iy = scharr_xy(img_i)
        gxx = _box_same(ix * ix, win)
        gxy = _box_same(ix * iy, win)
        gyy = _box_same(iy * iy, win)
        det = gxx * gyy - gxy * gxy
        min_eig = _min_eig_dense(ix, iy, win)
        good = (min_eig > config.min_eig_threshold) & (det > 1e-12)
        det_safe = jnp.where(good, det, 1.0)

        delta = err = None
        for rnd in range(2):
            j_w = warp_affine(
                img_j, _inv3x3(t_cur), border_value=0.0)
            r = j_w - img_i
            bx = _box_same(r * ix, win)
            by = _box_same(r * iy, win)
            dx = -(gyy * bx - gxy * by) / det_safe
            dy = -(gxx * by - gxy * bx) / det_safe
            delta = jnp.where(good[..., None], jnp.stack([dx, dy], axis=-1), 0.0)
            err = _box_same(jnp.abs(r), win) / float(win * win)
            if rnd == 0:
                ones = jnp.ones_like(min_eig, bool)
                t_cur = _grid_fit(
                    t_cur, delta, ones, min_eig, 1.0,
                    config.min_eig_threshold, resid_px=2.0, vote_range=3,
                )

    # ---- single sample at the query corners ---------------------------------
    samp = _sample_maps(
        jnp.stack([delta[..., 0], delta[..., 1], err, min_eig]), points
    )
    d_pts = samp[0:2].T                                   # (N, 2)
    err_pts = samp[2]
    me_pts = samp[3]

    new_pts = _apply_h(t_cur, points + d_pts)

    # Independent-motion gate, dense form: after two Newton rounds (with a
    # refit between), points following the GLOBAL motion have near-zero
    # residual delta; a large sampled final-round delta means the point's
    # true motion differs from the global similarity by more than the Newton
    # correction already applied — an independently moving object the dense
    # chain would otherwise snap onto the global motion (module docstring
    # gate (a)).  Same 1.5 px trust radius as the per-point polish clip.
    saturated = jnp.max(jnp.abs(d_pts), axis=-1) > 1.5

    # ---- optional per-point subpixel polish ---------------------------------
    # The dense maps are box-filtered at integer centers and sampled
    # bilinearly; a couple of classic per-point Newton iterations at the
    # exact corner positions recover the last ~0.2 px.  Patches come from
    # one-hot MXU extraction (_extract_bilinear_mxu) — no per-point gathers.
    if config.corner_polish_iters > 0:
        from video_stabilization.ops.lk import _scharr_patches

        polish_scope = jax.named_scope("stage_lk_polish")
        polish_scope.__enter__()
        pad = win + 4
        img_i_p = jnp.pad(img_i, pad, mode="reflect")
        img_j_p = jnp.pad(img_j, pad, mode="reflect")
        half = (win - 1) / 2.0

        ipatch_big = _extract_bilinear_mxu(
            img_i_p, points - (half + 1.0) + pad, win + 2)
        pix, piy = _scharr_patches(ipatch_big)
        ipatch = ipatch_big[:, 1:-1, 1:-1]
        pgxx = jnp.sum(pix * pix, axis=(1, 2))
        pgxy = jnp.sum(pix * piy, axis=(1, 2))
        pgyy = jnp.sum(piy * piy, axis=(1, 2))
        pdet = pgxx * pgyy - pgxy * pgxy
        p_ok = pdet > 1e-12
        pdet_s = jnp.where(p_ok, pdet, 1.0)

        v = new_pts
        for _ in range(config.corner_polish_iters):
            jpatch = _extract_bilinear_mxu(img_j_p, v - half + pad, win)
            r = jpatch - ipatch
            bx = jnp.sum(r * pix, axis=(1, 2))
            by = jnp.sum(r * piy, axis=(1, 2))
            dx = -(pgyy * bx - pgxy * by) / pdet_s
            dy = -(pgxx * by - pgxy * bx) / pdet_s
            step = jnp.stack([dx, dy], axis=-1)
            # trust region: the dense estimate is within ~1 px for points on
            # the global motion.  A saturating step means the dense estimate
            # was off by more than the clip — an independently moving point
            # the dense chain snapped to the global motion; drop it (the
            # reference's per-point LK would have tracked it elsewhere and
            # RANSAC would have rejected it).
            saturated = saturated | (
                p_ok & (jnp.max(jnp.abs(step), axis=-1) > 1.5)
            )
            step = jnp.clip(step, -1.5, 1.5)
            v = v + jnp.where(p_ok[:, None], step, 0.0)
        new_pts = v
        polish_scope.__exit__(None, None, None)
    in_final = (
        (new_pts[:, 0] >= 0.0) & (new_pts[:, 1] >= 0.0)
        & (new_pts[:, 0] < w0) & (new_pts[:, 1] < h0)
    )
    status = (
        valid & in_final & (me_pts > config.min_eig_threshold)
        & jnp.isfinite(err_pts) & jnp.all(jnp.isfinite(new_pts), axis=-1)
        & ~saturated
    )
    # residual-vs-cohort gate: err_pts is the |I - J∘warp| window mean under
    # the GLOBAL motion; for the (majority) static scene it is sensor noise +
    # interpolation error, while points on independently moving objects or
    # occlusions sit far above that cohort.  The threshold adapts to scene
    # noise via the median over currently-valid points.
    n_pts = points.shape[0]
    masked_err = jnp.where(status, err_pts, jnp.inf)
    cnt = jnp.sum(status.astype(jnp.int32))
    med = jnp.sort(masked_err)[jnp.clip(cnt // 2, 0, n_pts - 1)]
    med = jnp.where(jnp.isfinite(med), med, 0.0)
    status = status & (err_pts <= jnp.maximum(5.0 * med, 10.0))
    out_pts = jnp.where(status[:, None], new_pts, points)
    return LKResult(points=out_pts, status=status, error=err_pts)
