"""Jitted Lloyd k-means for the IVF coarse quantizer.

Replaces FAISS's IVFFlat ``train`` (reference backends.py:287-293) with a
pure-XLA k-means: assignment is a chunked matmul + argmin (matmul work), the
update is a ``segment_sum`` scatter.  Everything runs under ``lax.scan`` with
static shapes — no host round trips between iterations.
"""

from __future__ import annotations

from typing import Any

from functools import partial

import jax
import jax.numpy as jnp

ASSIGN_CHUNK = 16384  # rows per assignment matmul block


def _pad_rows(x: jax.Array, multiple: int) -> jax.Array:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = jnp.concatenate([x, jnp.zeros((rem,) + x.shape[1:], x.dtype)], axis=0)
    return x


@partial(jax.jit, static_argnames=("chunk",))
def assign_clusters(x: jax.Array, centroids: jax.Array, chunk: int = ASSIGN_CHUNK) -> jax.Array:
    """Nearest-centroid assignment, blocked so the [chunk, K] distance tile
    stays small regardless of corpus size.  Returns int32 [N]."""
    n = x.shape[0]
    cn = jnp.sum(centroids * centroids, axis=1)
    xp = _pad_rows(x.astype(jnp.float32), chunk)
    blocks = xp.reshape(-1, chunk, x.shape[1])

    def block_assign(xb: jax.Array) -> jax.Array:
        # argmin ||x - c||^2 == argmin (|c|^2 - 2 x.c); |x|^2 is constant per row.
        d = cn[None, :] - 2.0 * jnp.dot(xb, centroids.T, preferred_element_type=jnp.float32)
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    out = jax.lax.map(block_assign, blocks)
    return out.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("chunk",))
def assign_clusters_top2(
    x: jax.Array, centroids: jax.Array, chunk: int = ASSIGN_CHUNK
) -> tuple[jax.Array, jax.Array]:
    """Two nearest centroids per row plus the assignment margin.

    Returns ``(assign2 [N, 2] int32, margin [N] f32)`` where ``margin`` is
    ``d2 - d1`` (squared-distance gap; small = near a cluster boundary).
    Powers the IVF spill tier: boundary docs — exactly the ones a
    boundary QUERY's probe set misses — get a copy in their second-best
    bucket (scripts/profile_ivf_recall_curve.py measures the miss).  Same
    blocked [chunk, K] tiling as :func:`assign_clusters`.
    """
    n = x.shape[0]
    cn = jnp.sum(centroids * centroids, axis=1)
    xp = _pad_rows(x.astype(jnp.float32), chunk)
    blocks = xp.reshape(-1, chunk, x.shape[1])

    def block_assign(xb: jax.Array) -> tuple[jax.Array, jax.Array]:
        d = cn[None, :] - 2.0 * jnp.dot(
            xb, centroids.T, preferred_element_type=jnp.float32
        )
        nd2, idx2 = jax.lax.top_k(-d, 2)  # top-2 smallest distances
        return idx2.astype(jnp.int32), nd2[:, 0] - nd2[:, 1]

    a2, margin = jax.lax.map(block_assign, blocks)
    return (
        a2.reshape(-1, 2)[:n],
        margin.reshape(-1)[:n],
    )


@partial(jax.jit, static_argnames=("n_clusters", "n_iters", "spherical", "chunk"))
def kmeans(
    x: jax.Array,
    key: jax.Array,
    n_clusters: int,
    n_iters: int = 10,
    spherical: bool = False,
    chunk: int = ASSIGN_CHUNK,
) -> tuple[jax.Array, jax.Array]:
    """Fit ``n_clusters`` centroids on ``x [N, D]``; returns (centroids, assign).

    ``spherical=True`` re-normalizes centroids each iteration (cosine space).
    Empty clusters keep their previous centroid.
    """
    x = x.astype(jnp.float32)
    n = x.shape[0]
    init_idx = jax.random.permutation(key, n)[:n_clusters]
    cent0 = x[init_idx]
    if spherical:
        from .similarity import l2_normalize

        cent0 = l2_normalize(cent0)

    ones = jnp.ones((n, 1), jnp.float32)

    def step(cent: jax.Array, _: Any) -> Any:
        a = assign_clusters(x, cent, chunk=chunk)
        sums = jax.ops.segment_sum(x, a, num_segments=n_clusters)
        counts = jax.ops.segment_sum(ones, a, num_segments=n_clusters)
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), cent)
        if spherical:
            from .similarity import l2_normalize

            new = l2_normalize(new)
        return new, None

    cent, _ = jax.lax.scan(step, cent0, None, length=n_iters)
    return cent, assign_clusters(x, cent, chunk=chunk)
