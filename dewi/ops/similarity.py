"""Fused similarity + DEWI re-rank + top-k search kernels.

This replaces the reference's three native search paths (hnswlib graph
queries, FAISS IVF scans, and the numpy brute-force with its top-2k
over-fetch, reference backends.py:217-240, 326-355, 430-479) with a single
XLA computation:

  sim = Q @ E^T      (the matmul, the FLOPs)
  adj = (1-eta)*sim + eta*dewi + entropy_pref*(ht_mean+hi_mean)/2   (fused epilogue)
  top-k over masked valid rows                                     (lax.top_k)

Folding the re-rank *into* the score before top-k makes the re-rank exact
over the whole corpus, so the reference's 2k-candidate over-fetch
(backends.py:438-444) is unnecessary: the result is the true argmax of the
adjusted score.  XLA fuses the elementwise re-rank into the matmul epilogue;
everything stays in device-resident arrays with no host round trips.

Precision.  A float32 matmul may run in TF32 on a GPU unless told otherwise,
so every computation that calls itself exact — the f32 exact tier, the f32
refine of the quantized tiers, and every recall ground truth — asks for
``EXACT_PRECISION``.  The reduced tiers state theirs: the bf16 tier runs
bf16 x bf16 with f32 accumulation, the int8 tiers int8 x bf16 (or int8 x
int8 with int32 accumulation) in stage 1.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG_INF = float("-inf")  # python float: no backend init at import time
# The one precision of every f32 computation that calls itself exact.
EXACT_PRECISION = jax.lax.Precision.HIGHEST


def l2_normalize(x: jax.Array, eps: float = 0.0) -> jax.Array:
    """Row-wise L2 normalization; zero vectors pass through unchanged.

    Matches the reference's query guard ``if query_norm > 0``
    (backends.py:422-424).
    """
    x = x.astype(jnp.float32)
    norm = jnp.linalg.norm(x, axis=-1, keepdims=True)
    return jnp.where(norm > eps, x / jnp.where(norm > 0, norm, 1.0), x)


def rerank_scores(
    sim: jax.Array, payloads: jax.Array, eta: jax.Array, entropy_pref: jax.Array
) -> jax.Array:
    """DEWI-blended adjusted score (reference backends.py:460-465).

    ``sim``: [Q, N] similarity; ``payloads``: [N, 8] in PAYLOAD_FIELDS order
    (dewi at column 0, ht_mean at 1, hi_mean at 3).
    """
    dewi = payloads[:, 0]
    mean_entropy = 0.5 * (payloads[:, 1] + payloads[:, 3])
    return (
        (1.0 - eta) * sim
        + eta * dewi[None, :]
        + entropy_pref * mean_entropy[None, :]
    )


@partial(jax.jit, static_argnames=("k", "normalize", "blockmax_select"))
def fused_search(
    embeddings: jax.Array,   # [cap, D] — pre-normalized rows if cosine
    sqnorms: jax.Array,      # [cap]    — row squared norms (L2 path)
    payloads: jax.Array,     # [cap, 8] — PAYLOAD_FIELDS order
    queries: jax.Array,      # [Q, D]
    n_valid: jax.Array,      # scalar int32: number of live rows
    eta: jax.Array,          # scalar f32
    entropy_pref: jax.Array, # scalar f32
    k: int = 10,
    normalize: bool = True,  # True: cosine; False: negative squared L2
    blockmax_select: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Exact DEWI search over the full store: returns ([Q,k] scores, [Q,k] idx).

    Rows at index >= n_valid (growth slack in the capacity buffer) are masked
    to -inf before top-k, so capacity doubling never changes results.  An
    f32 corpus is scored at ``EXACT_PRECISION``; a bf16 corpus is scored
    bf16 x bf16 with f32 accumulation (the query is cast to bf16).

    ``blockmax_select`` replaces the full ``lax.top_k`` over the ``[Q, cap]``
    adjusted scores with hierarchical block-max selection: max-reduce each
    128-doc sub-block, exact top-``k`` over the ``[Q, cap/128]`` maxima,
    then top-``k`` over only the winning blocks' scores.  Unlike the
    quantized tier (where selection runs on approximate stage-1 scores and
    needs margin blocks), here the scores ARE the final adjusted scores, so
    top-``k`` blocks by max provably contain the top-``k`` docs: the block
    holding the rank-``i`` doc (``i <= k``) has max >= that doc's score, and
    at most ``k-1`` blocks can hold a doc scoring strictly higher — result
    values are EXACT (tie-broken doc *ids* can differ from the flat top-k
    when distinct docs share a score to the last f32 ulp).  It gathers
    candidate *scores* only (``k*128`` f32/query — cheap at any batch size).
    """
    q = queries.astype(jnp.float32)
    if normalize:
        q = l2_normalize(q)

    # Re-rank + validity mask folded into per-row mult/add vectors so the
    # [Q, cap] epilogue is one fused multiply-add (separate scale / re-rank
    # / mask passes each cost an extra [cap]-wide kernel).  Algebra:
    #   cosine: adj = dots*(1-eta) + [eta*dewi + ep*ent - inf_pad]
    #   L2:     adj = dots*2(1-eta)
    #               + [eta*dewi + ep*ent - (1-eta)*|e|^2 - inf_pad]
    #               - (1-eta)*|q|^2
    one_m_eta = 1.0 - eta
    add = (
        eta * payloads[:, 0]
        + entropy_pref * 0.5 * (payloads[:, 1] + payloads[:, 3])
    )
    if normalize:
        mult = one_m_eta * jnp.ones(embeddings.shape[0], jnp.float32)
    else:
        mult = 2.0 * one_m_eta * jnp.ones(embeddings.shape[0], jnp.float32)
        add = add - one_m_eta * sqnorms
    valid = jnp.arange(embeddings.shape[0], dtype=jnp.int32) < n_valid
    add = jnp.where(valid, add, NEG_INF)

    from .quantized import BLOCKMAX_SUB

    cap = embeddings.shape[0]
    nq = q.shape[0]
    sub = BLOCKMAX_SUB
    blockmax_ok = (
        blockmax_select and cap % sub == 0 and cap >= 4 * sub
    )
    nb = cap // sub
    s = min(nb, k)  # exact: top-k docs live in the top-k blocks by max

    if embeddings.dtype == jnp.bfloat16:
        dots = jnp.dot(q.astype(jnp.bfloat16), embeddings.T,
                       preferred_element_type=jnp.float32)
    else:
        dots = jnp.dot(q, embeddings.T.astype(jnp.float32),
                       preferred_element_type=jnp.float32,
                       precision=EXACT_PRECISION)
    adj = dots * mult[None, :] + add[None, :]
    if not normalize:
        adj = adj - one_m_eta * jnp.sum(q * q, axis=-1, keepdims=True)
    if blockmax_ok:
        # The max-reduce reads the materialized scores once
        # (bandwidth-bound), then only the winning blocks' SCORES are
        # gathered (k*128 f32 per query) — no embedding re-read, identical
        # values to the flat top-k at any batch size.
        adj3 = adj.reshape(nq, nb, sub)
        bmax = jnp.max(adj3, axis=-1)                         # [Q, nb]
        _, bid = jax.lax.top_k(bmax, s)                       # [Q, s]
        cs = jnp.take_along_axis(adj3, bid[:, :, None], axis=1)
        cand = (
            bid[:, :, None] * sub
            + jnp.arange(sub, dtype=bid.dtype)[None, None, :]
        ).reshape(nq, s * sub)
        vals, pos = jax.lax.top_k(cs.reshape(nq, s * sub), k)
        return vals, jnp.take_along_axis(cand, pos, axis=1)
    return jax.lax.top_k(adj, k)


@partial(jax.jit, static_argnames=("k",))
def topk_merge(
    scores: jax.Array, indices: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Merge per-shard candidate lists: ([Q, S*k] scores, [Q, S*k] global idx)
    -> global ([Q, k], [Q, k]).  Used by the distributed search after
    all-gathering each shard's local top-k."""
    vals, pos = jax.lax.top_k(scores, k)
    return vals, jnp.take_along_axis(indices, pos, axis=1)


@jax.jit
def pairwise_cosine(a: jax.Array, b: jax.Array) -> jax.Array:
    """Normalized [Na, Nb] cosine similarity matrix.

    The embedding-space primitive behind cross-modal dependency
    (reference cross_modal.py:132-139) and redundancy
    (reference redundancy.py:28-39).
    """
    return jnp.dot(
        l2_normalize(a), l2_normalize(b).T, preferred_element_type=jnp.float32
    )


__all__ = [
    "EXACT_PRECISION",
    "l2_normalize",
    "rerank_scores",
    "fused_search",
    "topk_merge",
    "pairwise_cosine",
]
