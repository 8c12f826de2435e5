"""SIFT detect + describe — DoG scale space, fixed shapes, batched binning.

Equivalent of cv::SIFT with the reference's hyperparameters
(src/stabilizer.cpp:496-507): 2500-feature budget, 3 octave layers, contrast
threshold 0.04, edge threshold 5, sigma 1.2.

Deviations from OpenCV by default (behavioral parity, validated by
registration tests + a statistical descriptor-parity test — SURVEY.md §7
"validate against OpenCV descriptors statistically"):
- no initial 2x upsampling of the input (fewer fine-scale keypoints) —
  cv2's upsampled -1 octave is available via ``SIFTConfig.upsample_2x``;
- subpixel refinement is a 2-D quadratic fit in (x, y) at the detected
  layer (OpenCV interpolates in scale too);
- one orientation per keypoint by default — cv2's duplicate keypoints at
  secondary orientation peaks (>= 0.8 * max) are available via
  ``SIFTConfig.multi_orientation``.

Structure:
- **Scale space**: per octave, nOctaveLayers+3 Gaussian images via separable
  incremental blurs (static kernel sizes); DoG differences are elementwise.
- **Extrema**: 3x3x3 neighborhood comparison as fused reduce_window ops +
  contrast prefilter + 2x2 Hessian edge rejection — all dense map ops.
- **Per-octave-layer top-k** with area-proportional static budgets.
- **Orientation/descriptor**: per-keypoint axis-aligned gradient patches
  (one slice-gather each), then 36-bin orientation histograms and the
  4x4x8 descriptor binning computed as masked one-hot accumulations —
  batched matmul-style reductions, no scatters.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from video_stabilization.config import SIFTConfig
from video_stabilization.ops.pyramid import _reflect101_pad


def _fix_capacity(feats: "SIFTFeatures", cap: int) -> "SIFTFeatures":
    """Pad or top-k-truncate to exactly ``cap`` keypoint slots (octave/layer
    budgets depend on image size; the engine carry needs a fixed shape)."""
    n = feats.points.shape[0]
    if n == cap:
        return feats
    if n < cap:
        pad = cap - n
        return SIFTFeatures(
            points=jnp.pad(feats.points, ((0, pad), (0, 0))),
            angle=jnp.pad(feats.angle, (0, pad)),
            response=jnp.pad(feats.response, (0, pad)),
            size=jnp.pad(feats.size, (0, pad)),
            desc=jnp.pad(feats.desc, ((0, pad), (0, 0))),
            mask=jnp.pad(feats.mask, (0, pad)),
        )
    score = jnp.where(feats.mask, feats.response, -jnp.inf)
    _, idx = jax.lax.top_k(score, cap)
    return SIFTFeatures(
        points=feats.points[idx],
        angle=feats.angle[idx],
        response=feats.response[idx],
        size=feats.size[idx],
        desc=feats.desc[idx],
        mask=feats.mask[idx],
    )


class SIFTFeatures(NamedTuple):
    points: jax.Array     # (N, 2) f32 image coords at input resolution
    angle: jax.Array      # (N,) f32 radians
    response: jax.Array   # (N,) f32 |DoG| response
    size: jax.Array       # (N,) f32 keypoint diameter at input resolution
    desc: jax.Array       # (N, 128) f32 L2-normalized descriptors
    mask: jax.Array       # (N,) bool


def _gauss_blur(img: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian blur with a static kernel (host-side constants)."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    size = 2 * radius + 1
    p = _reflect101_pad(img, radius, axis=-2)
    rows = sum(float(k[i]) * jax.lax.slice_in_dim(p, i, i + img.shape[-2], axis=-2)
               for i in range(size))
    p = _reflect101_pad(rows, radius, axis=-1)
    return sum(float(k[i]) * jax.lax.slice_in_dim(p, i, i + img.shape[-1], axis=-1)
               for i in range(size))


def _extrema_mask(dog_prev, dog_cur, dog_next, contrast_thresh, edge_thresh):
    """3x3x3 extrema + contrast + edge tests on one DoG layer."""
    def win_max(x):
        return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")

    def win_min(x):
        return jax.lax.reduce_window(x, jnp.inf, jax.lax.min, (3, 3), (1, 1), "SAME")

    is_max = (
        (dog_cur >= win_max(dog_cur))
        & (dog_cur > win_max(dog_prev))
        & (dog_cur > win_max(dog_next))
    )
    is_min = (
        (dog_cur <= win_min(dog_cur))
        & (dog_cur < win_min(dog_prev))
        & (dog_cur < win_min(dog_next))
    )
    strong = jnp.abs(dog_cur) > contrast_thresh

    # 2x2 spatial Hessian edge rejection: tr²/det < (r+1)²/r
    d = dog_cur
    dxx = jnp.roll(d, -1, 1) + jnp.roll(d, 1, 1) - 2 * d
    dyy = jnp.roll(d, -1, 0) + jnp.roll(d, 1, 0) - 2 * d
    dxy = 0.25 * (
        jnp.roll(jnp.roll(d, -1, 0), -1, 1) + jnp.roll(jnp.roll(d, 1, 0), 1, 1)
        - jnp.roll(jnp.roll(d, -1, 0), 1, 1) - jnp.roll(jnp.roll(d, 1, 0), -1, 1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    not_edge = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)

    return (is_max | is_min) & strong & not_edge


def _subpixel_xy(dog, ys, xs):
    """2-D quadratic offsets at integer extrema (batched gather of 3x3)."""
    h, w = dog.shape

    def at(dy, dx):
        return dog[jnp.clip(ys + dy, 0, h - 1), jnp.clip(xs + dx, 0, w - 1)]

    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = at(0, 1) + at(0, -1) - 2 * at(0, 0)
    dyy = at(1, 0) + at(-1, 0) - 2 * at(0, 0)
    dxy = 0.25 * (at(1, 1) + at(-1, -1) - at(1, -1) - at(-1, 1))
    det = dxx * dyy - dxy * dxy
    det = jnp.where(jnp.abs(det) > 1e-10, det, 1.0)
    ox = -(dyy * dx - dxy * dy) / det
    oy = -(dxx * dy - dxy * dx) / det
    ox = jnp.clip(ox, -0.5, 0.5)
    oy = jnp.clip(oy, -0.5, 0.5)
    return ox, oy


_N_ORI_BINS = 36
_DESC_PATCH = 32          # axis-aligned gradient patch side for descriptors


def _orient_and_describe(gx: jax.Array, gy: jax.Array, pts: jax.Array,
                         mask: jax.Array, sigma_kp: float,
                         multi_orientation: bool = False,
                         ori_peak_ratio: float = 0.8):
    """Orientation + 128-d descriptor for keypoints on one scale layer.

    Gradient patches for ALL keypoints are extracted in one pair of one-hot
    matmuls (ops/patches.py) instead of a vmapped per-keypoint
    ``dynamic_slice``, which lowers to N gathers.  The
    orientation histogram and the 4x4x8 descriptor bins are masked-weight
    reductions — no scatters anywhere.

    With ``multi_orientation`` (cv2 parity: cv::SIFT emits an extra keypoint
    per orientation-histogram local peak >= 0.8 * max —
    calcOrientationHist/SIFT_ORI_PEAK_RATIO), also returns the strongest
    secondary peak's angle + descriptor + a has-second mask; returns
    (angles, descs, angles2, descs2, has2) instead of (angles, descs).
    """
    from video_stabilization.ops.patches import extract_patches_mxu

    half = _DESC_PATCH // 2
    pad = half + 1
    gxp = jnp.pad(gx, pad)
    gyp = jnp.pad(gy, pad)

    # static coordinate offsets of the patch
    dy = np.arange(_DESC_PATCH) - half + 0.5
    dxs = np.arange(_DESC_PATCH) - half + 0.5
    offy = np.tile(dy[:, None], (1, _DESC_PATCH)).reshape(-1).astype(np.float32)
    offx = np.tile(dxs[None, :], (_DESC_PATCH, 1)).reshape(-1).astype(np.float32)
    r2 = offx ** 2 + offy ** 2

    # orientation window: Gaussian sigma = 1.5 * sigma_kp, radius 4.5 sigma
    ori_sigma = 1.5 * sigma_kp
    ori_w = np.exp(-r2 / (2 * ori_sigma ** 2)).astype(np.float32)
    ori_w = np.where(r2 <= (4.5 * ori_sigma) ** 2, ori_w, 0.0)

    # descriptor geometry: 4x4 spatial bins, bin width 3 * sigma_kp
    bin_w = 3.0 * sigma_kp

    # batched gradient-patch extraction: two one-hot matmuls for ALL
    # keypoints (the only per-point memory access in this function)
    iy_tl = pts[:, 1].astype(jnp.int32) + (pad - half)
    ix_tl = pts[:, 0].astype(jnp.int32) + (pad - half)
    hp, wp = gxp.shape
    iy_tl = jnp.clip(iy_tl, 0, hp - _DESC_PATCH)
    ix_tl = jnp.clip(ix_tl, 0, wp - _DESC_PATCH)
    patches = extract_patches_mxu(
        jnp.stack([gxp, gyp]), iy_tl, ix_tl, _DESC_PATCH
    )                                                    # (N, 2, P, P)
    pgx_all = patches[:, 0].reshape(patches.shape[0], -1)
    pgy_all = patches[:, 1].reshape(patches.shape[0], -1)

    def one(pgx, pgy):
        mag = jnp.sqrt(pgx * pgx + pgy * pgy)
        ang = jnp.arctan2(pgy, pgx)

        # --- orientation: 36-bin weighted histogram, smoothed, peak --------
        bins = jnp.mod(ang / (2 * jnp.pi) * _N_ORI_BINS, _N_ORI_BINS)
        b0 = jnp.floor(bins)
        fb = bins - b0
        b0i = b0.astype(jnp.int32) % _N_ORI_BINS
        onehot0 = jax.nn.one_hot(b0i, _N_ORI_BINS)
        onehot1 = jax.nn.one_hot((b0i + 1) % _N_ORI_BINS, _N_ORI_BINS)
        wmag = mag * ori_w
        hist = jnp.sum(wmag[:, None] * ((1 - fb)[:, None] * onehot0
                                        + fb[:, None] * onehot1), axis=0)
        # circular [1,1,1]/3 smoothing x2
        for _ in range(2):
            hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0

        def peak_theta(peak):
            # parabola on the circular neighborhood
            hl = hist[(peak - 1) % _N_ORI_BINS]
            hc = hist[peak]
            hr = hist[(peak + 1) % _N_ORI_BINS]
            denom = hl - 2 * hc + hr
            off = jnp.where(jnp.abs(denom) > 1e-10, 0.5 * (hl - hr) / denom, 0.0)
            return (peak.astype(jnp.float32) + off) * (2 * jnp.pi / _N_ORI_BINS)

        peak = jnp.argmax(hist)
        theta = peak_theta(peak)

        def describe(theta):
            return _describe_at(theta, mag, ang, bin_w, offx, offy)

        if not multi_orientation:
            return theta, describe(theta)

        # strongest secondary local peak (circular), cv2's 0.8 ratio
        is_local = (hist >= jnp.roll(hist, 1)) & (hist >= jnp.roll(hist, -1))
        sec = jnp.where(
            is_local & (jnp.arange(_N_ORI_BINS) != peak), hist, -jnp.inf
        )
        peak2 = jnp.argmax(sec)
        has2 = sec[peak2] >= ori_peak_ratio * hist[peak]
        theta2 = peak_theta(peak2)
        return theta, describe(theta), theta2, describe(theta2), has2

    if multi_orientation:
        angles, descs, angles2, descs2, has2 = jax.vmap(one)(pgx_all, pgy_all)
        descs = jnp.where(mask[:, None], descs, 0.0)
        descs2 = jnp.where((mask & has2)[:, None], descs2, 0.0)
        return angles, descs, angles2, descs2, has2
    angles, descs = jax.vmap(one)(pgx_all, pgy_all)
    descs = jnp.where(mask[:, None], descs, 0.0)
    return angles, descs


def _describe_at(theta, mag, ang, bin_w, offx, offy):
    """4x4x8 SIFT descriptor for one keypoint's gradient patch at
    orientation ``theta`` (vmapped by the caller)."""
    # --- descriptor: rotate coords/orientations into the kp frame ----------
    c, s = jnp.cos(-theta), jnp.sin(-theta)
    u = (c * offx - s * offy) / bin_w          # descriptor-frame coords
    v = (s * offx + c * offy) / bin_w
    # orientation-bin axis follows cv::SIFT's convention: our gradients are
    # y-DOWN (ang = atan2(dI/dy_down, dI/dx)) while cv2's are y-up, so the
    # relative angle is negated before binning (measured: this single sign
    # lifts coincident-keypoint descriptor cosine vs cv2 from 0.58 to 0.94
    # median; orientation histograms are direction-agnostic so only the
    # descriptor layout needs it).
    rel_ang = jnp.mod(theta - ang, 2 * jnp.pi)

    ub = u + 2.0 - 0.5                         # spatial bin coordinates
    vb = v + 2.0 - 0.5
    ob = rel_ang / (2 * jnp.pi) * 8.0

    w_desc = jnp.exp(-(u * u + v * v) / (2 * 2.0 ** 2)) * mag

    u0 = jnp.floor(ub)
    v0 = jnp.floor(vb)
    o0 = jnp.floor(ob)
    fu = ub - u0
    fv = vb - v0
    fo = ob - o0

    desc = jnp.zeros((4, 4, 8))
    for du in (0, 1):
        wu = jnp.where(du == 0, 1 - fu, fu)
        ui = u0 + du
        u_ok = (ui >= 0) & (ui <= 3)
        uoh = jax.nn.one_hot(jnp.clip(ui, 0, 3).astype(jnp.int32), 4)
        for dv in (0, 1):
            wv = jnp.where(dv == 0, 1 - fv, fv)
            vi = v0 + dv
            v_ok = (vi >= 0) & (vi <= 3)
            voh = jax.nn.one_hot(jnp.clip(vi, 0, 3).astype(jnp.int32), 4)
            for do in (0, 1):
                wo = jnp.where(do == 0, 1 - fo, fo)
                oi = (o0 + do) % 8
                ooh = jax.nn.one_hot(oi.astype(jnp.int32), 8)
                w = w_desc * wu * wv * wo * u_ok * v_ok
                # TF32 accepted: ~1e-3 relative error per bin, far inside
                # the 0.2 clip and the L2 match-distance filter
                desc = desc + jnp.einsum(
                    "p,pa,pb,pc->abc", w, voh, uoh, ooh
                )
    d = desc.reshape(-1)
    norm = jnp.linalg.norm(d) + 1e-7
    d = jnp.minimum(d / norm, 0.2)             # SIFT clip + renormalize
    d = d / (jnp.linalg.norm(d) + 1e-7)
    return d.astype(jnp.float32)

def sift_detect_and_compute(
    img: jax.Array, config: SIFTConfig = SIFTConfig()
) -> SIFTFeatures:
    """Detect + describe on a (H, W) float32 grayscale image (0..255)."""
    h, w = img.shape
    img = img.astype(jnp.float32) / 255.0
    if config.upsample_2x:
        # cv2 parity: build the scale space on a 2x-upsampled base (cv::SIFT
        # createInitialImage; assumed input blur 0.5 doubles to 1.0, so the
        # base blur tops up to sigma from there).  All output coordinates
        # and sizes map back by 0.5 via coord_scale below.
        from video_stabilization.ops.image import resize_bilinear

        work = resize_bilinear(img, 2 * h, 2 * w)
        base_sigma_inc = math.sqrt(max(config.sigma ** 2 - 1.0, 0.01))
        coord_scale = 0.5
    else:
        work = img
        base_sigma_inc = config.sigma
        coord_scale = 1.0
    wh, ww2 = work.shape
    n_layers = config.n_octave_layers
    n_octaves = max(1, int(math.floor(math.log2(min(wh, ww2) / 32.0))) + 1)
    k = 2.0 ** (1.0 / n_layers)
    contrast = 0.5 * config.contrast_threshold / n_layers

    # per-octave budgets proportional to area
    weights = [0.25 ** i for i in range(n_octaves)]
    total_w = sum(weights)
    budgets = [
        max(32, int(round(config.max_features * wt / total_w))) for wt in weights
    ]
    # trim to the exact total so output capacity is config.max_features
    while sum(budgets) > config.max_features:
        budgets[budgets.index(max(budgets))] -= sum(budgets) - config.max_features

    base = _gauss_blur(work, base_sigma_inc)
    octave_img = base

    all_pts, all_ang, all_resp, all_size, all_desc, all_mask = [], [], [], [], [], []
    for octave in range(n_octaves):
        oh, ow = octave_img.shape
        oct_scale = (2.0 ** octave) * coord_scale
        # Gaussian stack
        gauss = [octave_img]
        sig_prev = config.sigma
        for i in range(1, n_layers + 3):
            sig_total = config.sigma * (k ** i)
            sig_inc = math.sqrt(max(sig_total ** 2 - sig_prev ** 2, 0.01))
            gauss.append(_gauss_blur(gauss[-1], sig_inc))
            sig_prev = sig_total
        dog = [gauss[i + 1] - gauss[i] for i in range(n_layers + 2)]

        budget_layer = max(16, budgets[octave] // n_layers)
        for layer in range(1, n_layers + 1):
            mask2d = _extrema_mask(
                dog[layer - 1], dog[layer], dog[layer + 1],
                contrast, config.edge_threshold,
            )
            resp = jnp.where(mask2d, jnp.abs(dog[layer]), 0.0)
            # keep clear of borders for patch extraction
            border = 8
            valid_region = jnp.zeros((oh, ow), bool)
            if oh > 2 * border and ow > 2 * border:
                valid_region = valid_region.at[border:-border, border:-border].set(True)
            resp = jnp.where(valid_region, resp, 0.0)

            flat = resp.reshape(-1)
            top, idx = jax.lax.top_k(flat, budget_layer)
            ys = (idx // ow).astype(jnp.int32)
            xs = (idx % ow).astype(jnp.int32)
            kp_mask = top > 0

            ox, oy = _subpixel_xy(dog[layer], ys, xs)
            pts_layer = jnp.stack(
                [xs.astype(jnp.float32) + ox, ys.astype(jnp.float32) + oy], -1
            )

            sigma_kp = config.sigma * (k ** layer)
            gl = gauss[layer]
            gx = 0.5 * (jnp.roll(gl, -1, 1) - jnp.roll(gl, 1, 1))
            gy = 0.5 * (jnp.roll(gl, -1, 0) - jnp.roll(gl, 1, 0))
            res = _orient_and_describe(
                gx, gy, pts_layer, kp_mask, sigma_kp,
                multi_orientation=config.multi_orientation,
                ori_peak_ratio=config.ori_peak_ratio,
            )
            if config.multi_orientation:
                ang, desc, ang2, desc2, has2 = res
            else:
                ang, desc = res

            all_pts.append(pts_layer * oct_scale)
            all_ang.append(ang)
            all_resp.append(top)
            all_size.append(
                jnp.full((budget_layer,), 2.0 * sigma_kp * oct_scale)
            )
            all_desc.append(desc)
            all_mask.append(kp_mask)
            if config.multi_orientation:
                # second keypoint at the secondary orientation peak (cv2
                # emits a duplicate keypoint lane; slightly lower response
                # so capacity truncation prefers the primary)
                all_pts.append(pts_layer * oct_scale)
                all_ang.append(ang2)
                all_resp.append(top * 0.999)
                all_size.append(
                    jnp.full((budget_layer,), 2.0 * sigma_kp * oct_scale)
                )
                all_desc.append(desc2)
                all_mask.append(kp_mask & has2)

        octave_img = gauss[n_layers][::2, ::2]

    feats = SIFTFeatures(
        points=jnp.concatenate(all_pts, axis=0),
        angle=jnp.concatenate(all_ang),
        response=jnp.concatenate(all_resp),
        size=jnp.concatenate(all_size),
        desc=jnp.concatenate(all_desc, axis=0),
        mask=jnp.concatenate(all_mask),
    )
    feats = _fix_capacity(feats, config.max_features)
    # relative keypoint-size filter (reference ratio 0.05 for SIFT,
    # src/stabilizer.cpp:496-507, filterKeypointByRelativeSize :290-309)
    keep = feats.size <= (h * config.max_keypoint_size_ratio)
    return feats._replace(mask=feats.mask & keep)
