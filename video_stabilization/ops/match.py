"""Descriptor matching as matrix products.

- ORB: brute-force Hamming kNN (k=2) + Lowe ratio test 0.6 (reference:
  BFMatcher(NORM_HAMMING).knnMatch, src/stabilizer.cpp:647-673).  With
  descriptors as ±1 int8 vectors, Hamming(a, b) = (nbits − a·b) / 2, so the
  full distance matrix is ONE (N × 256)·(256 × M) matmul — the systolic
  array does in microseconds what a CPU BFMatcher does in milliseconds.
- SIFT: L2 matching + the reference's mean-distance filter
  (distance ≤ max(0.5·avg, 0.02), src/stabilizer.cpp:675-707), with
  ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b — again one matmul.

Both return fixed-shape match arrays with validity masks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Matches(NamedTuple):
    idx: jax.Array       # (N,) int32 — best match in the second set
    distance: jax.Array  # (N,) float32
    valid: jax.Array     # (N,) bool — passed masking + ratio/threshold tests


_BIG = 1e9


def match_hamming_knn(
    desc1: jax.Array, mask1: jax.Array,
    desc2: jax.Array, mask2: jax.Array,
    lowe_ratio: float = 0.6,
) -> Matches:
    """kNN (k=2) Hamming matching of ±1 int8 descriptor sets + ratio test."""
    nbits = desc1.shape[1]
    a = desc1.astype(jnp.bfloat16)
    b = desc2.astype(jnp.bfloat16)
    dots = jnp.dot(a, b.T, preferred_element_type=jnp.float32)   # (N, M)
    dist = 0.5 * (nbits - dots)

    dist = jnp.where(mask2[None, :], dist, _BIG)
    # top-2 smallest via two masked min-reductions instead of lax.top_k's
    # full row sort
    best = jnp.argmin(dist, axis=1)
    d1 = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    cols = jnp.arange(dist.shape[1], dtype=jnp.int32)[None, :]
    d2 = jnp.min(jnp.where(cols == best[:, None], _BIG, dist), axis=1)

    valid = mask1 & (d1 < _BIG / 2) & (d2 < _BIG / 2) & (d1 < lowe_ratio * d2)
    return Matches(idx=best.astype(jnp.int32), distance=d1, valid=valid)


def match_l2(
    desc1: jax.Array, mask1: jax.Array,
    desc2: jax.Array, mask2: jax.Array,
    avg_ratio: float = 0.5,
    min_distance: float = 0.02,
) -> Matches:
    """Nearest-neighbor L2 matching + the reference's SIFT distance filter:
    keep matches with distance <= max(avg_ratio * mean_distance, min_distance)
    where the mean is over valid best matches."""
    a = desc1.astype(jnp.float32)
    b = desc2.astype(jnp.float32)
    a2 = jnp.sum(a * a, axis=1, keepdims=True)
    b2 = jnp.sum(b * b, axis=1, keepdims=True)
    d2 = a2 + b2.T - 2.0 * jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    d2 = jnp.maximum(d2, 0.0)
    d2 = jnp.where(mask2[None, :], d2, _BIG)

    best = jnp.argmin(d2, axis=1)
    dist = jnp.sqrt(jnp.take_along_axis(d2, best[:, None], axis=1)[:, 0])

    base_valid = mask1 & (dist < _BIG / 2)
    n_valid = jnp.maximum(jnp.sum(base_valid), 1)
    avg = jnp.sum(jnp.where(base_valid, dist, 0.0)) / n_valid
    thresh = jnp.maximum(avg_ratio * avg, min_distance)
    valid = base_valid & (dist <= thresh)
    return Matches(idx=best.astype(jnp.int32), distance=dist, valid=valid)
