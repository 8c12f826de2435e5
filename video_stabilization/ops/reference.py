"""Plain numpy references for the device ops, for tests and chip checks.

Each function is a direct, loop-level statement of the op's definition,
independent of the jnp formulation it checks.
"""

from __future__ import annotations

import numpy as np

from video_stabilization.ops.fast import ARC_LEN, CIRCLE_OFFSETS


def warp_bilinear_reference(src: np.ndarray, h: np.ndarray,
                            border_value=0.0) -> np.ndarray:
    """float64 ``cv::warpPerspective(INTER_LINEAR, BORDER_CONSTANT)``:
    each destination pixel samples ``src`` at ``inv(h) @ (x, y, 1)`` by
    bilinear interpolation of its 4 neighbouring taps, a tap outside the
    source reading ``border_value`` (scalar or per channel).  Output is the
    size of src."""
    src = np.asarray(src, np.float64)
    hh, ww = src.shape[:2]
    hinv = np.linalg.inv(np.asarray(h, np.float64))
    border = np.broadcast_to(np.asarray(border_value, np.float64),
                             src.shape[2:])
    ys, xs = np.mgrid[0:hh, 0:ww].astype(np.float64)
    den = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
    sx = (hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / den
    sy = (hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / den
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = sx - x0
    fy = sy - y0
    out = np.zeros(src.shape, np.float64)
    for yi, wy in ((y0, 1 - fy), (y0 + 1, fy)):
        for xi, wx in ((x0, 1 - fx), (x0 + 1, fx)):
            inside = (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
            tap = src[np.clip(yi, 0, hh - 1), np.clip(xi, 0, ww - 1)]
            w = wy * wx
            if src.ndim == 3:
                inside, w = inside[..., None], w[..., None]
            out += w * np.where(inside, tap, border)
    return out


def fast_score_reference(img: np.ndarray, threshold: float) -> np.ndarray:
    """Brute-force FAST-9/16 score map (float32, zero where not a corner).

    For every pixel at least 3 px from the border and every one of the 16
    arcs of ``ARC_LEN`` contiguous circle pixels: the bright margin of the
    arc is the smallest ``ring - p`` over it, the dark margin the smallest
    ``p - ring``.  The score is the largest margin over all arcs and both
    polarities; the pixel is a corner when the score exceeds ``threshold``.
    """
    img = np.asarray(img, np.float32)
    h, w = img.shape
    score = np.zeros((h, w), np.float32)
    if h <= 6 or w <= 6:
        return score
    center = img[3:h - 3, 3:w - 3]
    ring = [img[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] - center
            for dy, dx in CIRCLE_OFFSETS]
    best = np.full(center.shape, -np.inf, np.float32)
    for start in range(16):
        arc = [ring[(start + i) % 16] for i in range(ARC_LEN)]
        bright = arc[0]
        dark = -arc[0]
        for m in arc[1:]:
            bright = np.minimum(bright, m)
            dark = np.minimum(dark, -m)
        best = np.maximum(best, np.maximum(bright, dark))
    score[3:h - 3, 3:w - 3] = np.where(best > threshold, best, 0.0)
    return score
