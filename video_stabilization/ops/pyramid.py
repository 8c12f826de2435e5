"""Image pyramids for pyramidal Lucas-Kanade and ORB.

``pyr_down`` matches ``cv2.pyrDown``: separable 5-tap Gaussian
[1, 4, 6, 4, 1]/16 with reflect-101 borders, then decimation by 2 keeping
even-indexed pixels.  The reference builds its LK pyramids implicitly inside
``cv::calcOpticalFlowPyrLK`` (src/stabilizer.cpp:192-195, maxLevel=3); here
the pyramid is built once per frame and stored in the engine carry so
consecutive frames never recompute it (the reference recomputes both frames'
pyramids every call — a free 2x on that stage).

Pyramid levels are fixed shapes: level l has shape ceil(prev/2) following
OpenCV.  ``build_pyramid`` returns a tuple of arrays (a pytree), so it can
live inside a jitted carry.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Kernel constants are host (numpy) arrays: they lower to HLO constants
# inside the trace, where a module-level jnp array captured by a jitted
# function would become an extra runtime argument.
_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _reflect101_pad(img: jax.Array, pad: int, axis: int) -> jax.Array:
    """BORDER_REFLECT_101 padding (OpenCV default): edge pixel not repeated.

    Built from static slices + reversals + one concat — a take()-based
    version lowers to an HLO gather.
    """
    left = jax.lax.rev(
        jax.lax.slice_in_dim(img, 1, pad + 1, axis=axis), (axis % img.ndim,)
    )
    n = img.shape[axis]
    right = jax.lax.rev(
        jax.lax.slice_in_dim(img, n - 1 - pad, n - 1, axis=axis), (axis % img.ndim,)
    )
    return jnp.concatenate([left, img, right], axis=axis)


def sep_filter5(img: jax.Array, kernel: jax.Array = _K5) -> jax.Array:
    """Separable 5-tap filter with reflect-101 borders on (..., H, W)."""
    pad = 2
    x = _reflect101_pad(img, pad, axis=-2)
    rows = sum(
        kernel[i] * jax.lax.slice_in_dim(x, i, i + img.shape[-2], axis=-2)
        for i in range(5)
    )
    x = _reflect101_pad(rows, pad, axis=-1)
    return sum(
        kernel[i] * jax.lax.slice_in_dim(x, i, i + img.shape[-1], axis=-1)
        for i in range(5)
    )


def pyr_down(img: jax.Array) -> jax.Array:
    """One pyramid level down: 5x5 Gaussian blur + decimate by 2 (cv2.pyrDown).

    The decimation is folded into each separable pass as single-axis
    stride-2 slices (evaluate the blur at even rows/cols only).  A
    ``blurred[..., ::2, ::2]`` epilogue would compute the odd rows/columns
    only to drop them; this formulation skips them entirely.
    """
    img = img.astype(jnp.float32)
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = (h + 1) // 2, (w + 1) // 2
    x = _reflect101_pad(img, 2, axis=-2)
    rows = sum(
        _K5[k] * jax.lax.slice_in_dim(x, k, k + 2 * (oh - 1) + 1, stride=2, axis=-2)
        for k in range(5)
    )
    x = _reflect101_pad(rows, 2, axis=-1)
    return sum(
        _K5[k] * jax.lax.slice_in_dim(x, k, k + 2 * (ow - 1) + 1, stride=2, axis=-1)
        for k in range(5)
    )


def build_pyramid(img: jax.Array, levels: int) -> Tuple[jax.Array, ...]:
    """Levels 0..levels (inclusive), level 0 = input. Matches
    calcOpticalFlowPyrLK's maxLevel semantics (maxLevel=3 -> 4 images)."""
    pyr = [img.astype(jnp.float32)]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return tuple(pyr)
