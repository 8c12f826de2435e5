"""Image gradients: Sobel / Scharr separable filters (reflect-101 borders).

Used by the Shi-Tomasi corner response (Sobel, aperture 3 — matching
cv::goodFeaturesToTrack's gradientSize=3, reference src/stabilizer.cpp:942-945)
and by Lucas-Kanade patch derivatives (Scharr, matching OpenCV's
calcOpticalFlowPyrLK internals).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from video_stabilization.ops.pyramid import _reflect101_pad


def _sep3(img: jax.Array, kv: Tuple[float, float, float], kh: Tuple[float, float, float]) -> jax.Array:
    """3-tap separable filter: kv along rows (y), kh along cols (x)."""
    x = _reflect101_pad(img, 1, axis=-2)
    rows = sum(
        kv[i] * jax.lax.slice_in_dim(x, i, i + img.shape[-2], axis=-2)
        for i in range(3)
    )
    x = _reflect101_pad(rows, 1, axis=-1)
    return sum(
        kh[i] * jax.lax.slice_in_dim(x, i, i + img.shape[-1], axis=-1)
        for i in range(3)
    )


def sobel_xy(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Sobel dx, dy with 3x3 aperture (cv2.Sobel ksize=3 convention)."""
    img = img.astype(jnp.float32)
    ix = _sep3(img, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))
    iy = _sep3(img, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))
    return ix, iy


def scharr_xy(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Scharr dx, dy scaled by 1/32 (OpenCV LK derivative convention)."""
    img = img.astype(jnp.float32)
    ix = _sep3(img, (3 / 32, 10 / 32, 3 / 32), (-1.0, 0.0, 1.0))
    iy = _sep3(img, (-1.0, 0.0, 1.0), (3 / 32, 10 / 32, 3 / 32))
    return ix, iy


def box_sum(img: jax.Array, ksize: int) -> jax.Array:
    """ksize x ksize box sum with reflect-101 borders (structure tensor window)."""
    pad = ksize // 2
    x = _reflect101_pad(img, pad, axis=-2)
    rows = sum(
        jax.lax.slice_in_dim(x, i, i + img.shape[-2], axis=-2) for i in range(ksize)
    )
    x = _reflect101_pad(rows, pad, axis=-1)
    return sum(
        jax.lax.slice_in_dim(x, i, i + img.shape[-1], axis=-1) for i in range(ksize)
    )
