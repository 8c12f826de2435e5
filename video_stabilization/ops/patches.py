"""Batched patch extraction as matrix products — the shared gather-free
primitive.

A vmap of per-keypoint ``dynamic_slice`` reads lowers to N gathers.  This
formulation extracts ALL patches at once as two one-hot selection matmuls
(whether it beats a gather on the GPU is not measured yet):

    rows    = onehot(row_idx) @ image      (N·P, H) x (H, W)
    patches = rows @ onehot(col_idx)^T     per keypoint, (P, W) x (W, P)

Each is a large dense matmul the systolic array executes in microseconds;
the one-hot operands are built in-trace from iota comparisons (never
constant-folded into the executable — they are anchored on the input).

Used by ORB descriptor sampling (ops/orb.py) and SIFT descriptor gradients
(ops/sift.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_patches_mxu(
    planes: jax.Array, iy: jax.Array, ix: jax.Array, size: int
) -> jax.Array:
    """Extract (size x size) patches from each of C planes at N positions.

    Args:
      planes: (C, H, W) float array (shared image planes, e.g. raw+blurred
        or gx+gy).
      iy, ix: (N,) int32 top-left corners (pre-clipped to [0, H-size] /
        [0, W-size] by the caller).
      size: static patch side P.

    Returns:
      (N, C, P, P) float32 patches.
    """
    c, h, w = planes.shape
    planes16 = planes.astype(jnp.bfloat16)

    yidx = iy[:, None] + jnp.arange(size)[None, :]               # (N, P)
    rsel = (yidx[:, :, None] == jnp.arange(h)[None, None, :]).astype(
        jnp.bfloat16
    )
    xidx = ix[:, None] + jnp.arange(size)[None, :]               # (N, P)
    csel = (jnp.arange(w)[None, :, None] == xidx[:, None, :]).astype(
        jnp.bfloat16
    )
    # Select the smaller image axis first so the half-selected intermediate
    # is (N, C, min(H·P, P·W)) — for landscape planes column-first shrinks
    # it ~W/H x.  Both orders are bit-identical (each one-hot contraction
    # copies a single bf16 image entry; f32 accumulation is exact on a
    # one-hot operand), and keeping the intermediate in bf16 is exact for
    # the same reason — it already holds bf16 image values.
    if h <= w:
        cols = jnp.einsum(
            "chw,nwq->nchq", planes16, csel,
            preferred_element_type=jnp.bfloat16,
        )                                                        # (N, C, H, P)
        return jnp.einsum(
            "nph,nchq->ncpq", rsel, cols,
            preferred_element_type=jnp.float32,
        )                                                        # (N, C, P, P)
    rows = jnp.einsum(
        "nph,chw->ncpw", rsel, planes16, preferred_element_type=jnp.bfloat16
    )                                                            # (N, C, P, W)
    return jnp.einsum(
        "ncpw,nwq->ncpq", rows, csel,
        preferred_element_type=jnp.float32,
    )                                                            # (N, C, P, P)
