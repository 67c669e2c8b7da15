"""Int8 quantized scoring: ScaNN-style two-stage exact search.

No reference counterpart — the reference's ANN tiers are hnswlib graphs and
FAISS IVF (backends.py:166-383).  On an accelerator the binding constraint
for brute-force search is device-memory bandwidth (reading the ``[N, D]``
corpus), so the idiomatic design is quantization, not graphs:

* stage 1 — int8 matmul over the whole corpus (4× less memory traffic than
  f32), fused DEWI re-rank, take a top-``m`` candidate set
  (``m = refine_factor·k``);
* stage 2 — gather the ``m`` f32 rows, exact similarity, re-rank, top-k.

With refinement the result matches full-precision exact search except when
a true top-k member falls outside the int8 top-``m`` — at refine_factor≥4
measured recall is ~1.0 (see tests/test_quantized.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .pallas_search import kernel_fits, pallas_bmax
from .similarity import EXACT_PRECISION, l2_normalize

NEG_INF = float("-inf")  # python float: no backend init at import time

BLOCKMAX_SUB = 128  # sub-block width for blockmax_select
# Above this query count the blockmax tier switches refine strategy: the
# block-granular gather (s*128 docs/query) outgrows the flat path's m rows,
# so large batches gather candidate stage-1 SCORES from the winning blocks
# (s*128 f32/query — cheap), take top-m within them, and row-gather only m
# docs — selection quality >= approx_max_k's 0.95 target at the same
# refine traffic.
BLOCKMAX_REFINE_MAX_Q = 32
# approx_max_k only engages above this capacity: below it, exact top_k is
# ~free and approx's coarse reduction can dip under the 0.99 recall gate.
APPROX_SELECT_MIN_CAP = 1 << 17


@jax.jit
def quantize_rows(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-row symmetric int8 quantization: returns (int8 values, f32 scales).

    ``x ≈ values * scales[:, None]``; zero rows get scale 0 and quantize to 0.
    """
    x = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x), axis=-1)
    scale = absmax / 127.0
    safe = jnp.where(scale > 0, scale, 1.0)
    q = jnp.clip(jnp.round(x / safe[:, None]), -127, 127).astype(jnp.int8)
    return q, scale


@jax.jit
def quantize_rows_int4(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-row symmetric int4 quantization, nibble-packed 2-per-byte.

    Returns ``(packed [N, D/2] int8, scales [N] f32)``.  Values live in
    [-7, 7] (scale = absmax/7; the -8 code is unused so the grid is
    symmetric).  Byte ``j`` packs dimension ``j`` in its HIGH nibble
    (signed) and dimension ``j + D/2`` in its LOW nibble (biased by +8 so
    the unpack needs no sign propagation across the nibble boundary):

        byte_j = hi_j * 16 + (lo_j + 8),  hi_j = q(x[:, j]),
                                          lo_j = q(x[:, j + D/2])

    so ``hi = byte >> 4`` (arithmetic — floor division recovers the signed
    high nibble exactly because the low bits are non-negative) and
    ``lo = (byte & 15) - 8``.  The plane split (first half of dims in high
    nibbles, second half in low) means unpacking yields two ``[N, D/2]``
    tensors whose axis-1 concatenation restores the ORIGINAL dimension
    order — the query needs no permutation.  D must be even.

    Why int4: stage 1 of the two-stage search is bound by device-memory
    bandwidth — the corpus read is the whole cost.  Halving the bytes
    halves the stage-1 floor; the extra rounding error is absorbed by a wider
    refine margin (larger ``m``) in the exact f32 stage 2, recall-gated
    in bench like every other tier.
    """
    x = x.astype(jnp.float32)
    d = x.shape[-1]
    assert d % 2 == 0, f"int4 packing needs even dim, got {d}"
    absmax = jnp.max(jnp.abs(x), axis=-1)
    scale = absmax / 7.0
    safe = jnp.where(scale > 0, scale, 1.0)
    q = jnp.clip(jnp.round(x / safe[:, None]), -7, 7).astype(jnp.int8)
    hi = q[:, : d // 2]
    lo = q[:, d // 2 :]
    packed = (hi * 16 + (lo + 8)).astype(jnp.int8)
    return packed, scale


@jax.jit
def unpack_int4(packed: jax.Array) -> jax.Array:
    """Inverse of :func:`quantize_rows_int4`'s packing: ``[N, D] int8``.

    XLA reference implementation (also the stage-1 path wherever the s4
    kernel does not run); the kernel does the same two-op unpack in
    registers so the packed bytes are what streams from device memory.
    """
    # int8 arithmetic shift keeps the sign; & 15 isolates the biased low.
    hi = packed >> 4
    lo = (packed & 15) - 8
    return jnp.concatenate([hi, lo], axis=-1).astype(jnp.int8)


def stage1_mode(int8_queries: bool, int4_packed: bool) -> str:
    """Operand mode of stage 1 (see :mod:`dewi.ops.pallas_search`):
    ``s4`` packed int4 x int8 query, ``s8`` int8 x int8 query, ``bf16``
    int8 corpus x bf16 query."""
    if int4_packed:
        return "s4"
    return "s8" if int8_queries else "bf16"


def _block_scores(emb_q: jax.Array, bid: jax.Array, q: jax.Array,
                  q_i8: jax.Array | None, q_scale: jax.Array | None,
                  mult: jax.Array, add: jax.Array,
                  int4_packed: bool) -> jax.Array:
    """Stage-1 scores of the winning sub-blocks only: ``[Q, s, 128]``.

    The fused kernel keeps no ``[Q, cap]`` scores, so a large batch that
    needs candidate scores inside its winning blocks re-scores them from
    the gathered quantized rows with the kernel's own math."""
    nb = emb_q.shape[0] // BLOCKMAX_SUB
    rows = emb_q.reshape(nb, BLOCKMAX_SUB, emb_q.shape[1])[bid]  # [Q,s,128,W]
    if int4_packed:
        rows = unpack_int4(rows)
    if q_i8 is not None:
        acc = jnp.einsum(
            "qd,qsrd->qsr", q_i8, rows, preferred_element_type=jnp.int32
        ).astype(jnp.float32) * q_scale[:, None, None]
    else:
        acc = jnp.einsum(
            "qd,qsrd->qsr", q.astype(jnp.bfloat16), rows.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    return (acc * mult.reshape(nb, BLOCKMAX_SUB)[bid]
            + add.reshape(nb, BLOCKMAX_SUB)[bid])


@partial(
    jax.jit,
    static_argnames=(
        "k", "m", "normalize", "approx_select", "int8_queries",
        "bf16_scores", "blockmax_select", "bmax_kernel", "interpret",
        "int4_packed", "int4_values",
    ),
)
def quantized_search(
    emb_i8: jax.Array,    # [cap, D] int8 corpus ([cap, D/2] if int4_packed)
    scales: jax.Array,    # [cap] f32 row scales
    emb_f32: jax.Array,   # [cap, D] f32 corpus (refinement gather source)
    sqnorms: jax.Array,   # [cap] f32 row squared norms (L2 path)
    payloads: jax.Array,  # [cap, 8]
    queries: jax.Array,   # [Q, D]
    n_valid: jax.Array,   # scalar int32
    eta: jax.Array,
    entropy_pref: jax.Array,
    k: int,
    m: int,
    normalize: bool = True,
    approx_select: bool = True,
    int8_queries: bool = False,
    bf16_scores: bool = False,
    blockmax_select: bool = False,
    bmax_kernel: bool = False,
    interpret: bool = False,
    int4_packed: bool = False,
    int4_values: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Two-stage int8 -> f32 exact search; returns ([Q, k] scores, [Q, k] idx).

    Stage 1 runs at the tier's stated precision: int8 corpus x bf16 query
    with f32 accumulation, or int8 x int8 query (``int8_queries``) with
    int32 accumulation.  Stage 2 refines the candidates in f32 at
    ``EXACT_PRECISION``.

    ``approx_select=True`` picks stage-1 candidates with
    ``lax.approx_max_k`` (unaggregated) instead of exact ``top_k``;
    ``False`` restores exact selection (recall 1.0 within int8 stage-1
    resolution).

    ``bf16_scores=True`` materializes the stage-1 ``[Q, cap]`` score matrix
    in bf16 — halving its device-memory writeback and the selection pass's
    read for batched Q.  Selection consumes only the candidate *indices*
    and stage 2 re-ranks the candidates exactly in f32, so bf16 rounding
    only perturbs which candidates make the top-``m``.

    ``blockmax_select=True`` replaces the candidate select with a
    hierarchical sub-block max: reduce the ``[Q, cap]`` scores to the max
    of each 128-row sub-block, exact top-``s`` over the ``[Q, cap/128]``
    maxima (``s = max(k, ceil(m/128))``), and refine every doc in the
    winning sub-blocks (``s·128`` candidates).  Correctness: a sub-block
    containing a true stage-1 top-``s`` doc has max >= the s-th best
    score, so the top-``s`` sub-blocks contain ALL stage-1 top-``s`` >=
    top-``k`` docs — selection is exact w.r.t. stage-1 scores; residual
    error is int8 stage-1 rounding.  Above ``BLOCKMAX_REFINE_MAX_Q``
    queries the refine switches to a two-step gather (winning blocks'
    *scores* -> top-``m`` -> ``m``-row refine) so batched refine traffic
    matches the flat path instead of growing ``s*128`` rows per query.

    ``bmax_kernel=True`` (with ``blockmax_select``) computes the sub-block
    maxima with the fused stage-1 kernel (:mod:`dewi.ops.pallas_search`):
    the ``[Q, cap]`` scores never reach device memory.  Selection math is
    identical to the two-pass path.  ``interpret`` runs that kernel in the
    Pallas interpreter (CPU tests).

    ``int4_packed=True`` reads ``emb_i8`` as the ``[cap, D/2]``
    nibble-packed int4 corpus from :func:`quantize_rows_int4` — HALF the
    stage-1 stream of int8.  Only the fused kernel (``s4`` mode, which
    needs ``int8_queries``) reads the packed bytes; every other
    configuration unpacks via XLA first.  ``int4_values=True`` declares
    that ``emb_i8`` holds int4-GRID values in the plain unpacked ``[cap, D]``
    int8 layout (the index unpacks once at build time where the kernel
    does not run).  Either way int4's coarser grid gets a doubled blockmax
    margin — the rounding lives in the VALUES, not the layout."""
    int4_grid = int4_packed or int4_values
    q = queries.astype(jnp.float32)
    if normalize:
        q = l2_normalize(q)

    # Algebraic fold: dequant scale, DEWI re-rank, and the validity mask
    # collapse into per-row mult/add vectors, so the [Q, cap] epilogue is
    # ONE fused multiply-add over the score matrix instead of separate
    # scale / re-rank / mask passes.  Cosine:
    #   adj = (1-eta)*(acc*scale) + eta*dewi + ep*ent
    #       = acc * [(1-eta)*scale] + [eta*dewi + ep*ent - inf_pad]
    # L2 (sim = 2*e.q - |e|^2 - |q|^2 with e.q = acc*scale):
    #   adj = acc * [2(1-eta)*scale]
    #       + [-(1-eta)*|e|^2 + eta*dewi + ep*ent - inf_pad]
    #       - (1-eta)*|q|^2   (per-query constant — omitted: see NOTE below)
    ent = 0.5 * (payloads[:, 1] + payloads[:, 3])
    one_m_eta = 1.0 - eta
    add = eta * payloads[:, 0] + entropy_pref * ent
    if normalize:
        mult = one_m_eta * scales
    else:
        mult = 2.0 * one_m_eta * scales
        add = add - one_m_eta * sqnorms
    nq, cap, d = q.shape[0], emb_i8.shape[0], q.shape[1]
    blockmax_ok = (
        blockmax_select and cap % BLOCKMAX_SUB == 0
        and cap >= 4 * BLOCKMAX_SUB
    )
    use_kernel = (
        bmax_kernel and blockmax_ok
        and (int8_queries or not int4_packed)
        and kernel_fits(cap, d, stage1_mode(int8_queries, int4_packed))
    )
    if int4_packed and not use_kernel:
        # Only the s4 kernel reads packed nibbles; the XLA paths below read
        # the unpacked values (scales are already absmax/7, so the dequant
        # algebra is unchanged).
        emb_i8 = unpack_int4(emb_i8)
        int4_packed = False

    valid = jnp.arange(cap, dtype=jnp.int32) < n_valid
    if bf16_scores and not use_kernel:
        # Center the fold's additive term on its valid-row mean (a scalar
        # shift, identical across docs, so per-query ranking is invariant).
        # Under L2 ``add`` carries -(1-eta)*|e|^2 — large common magnitude
        # that bf16 would round away from the tiny score *differences*
        # that decide the top-m.
        denom = jnp.maximum(n_valid.astype(jnp.float32), 1.0)
        add = add - jnp.sum(jnp.where(valid, add, 0.0)) / denom
    add = jnp.where(valid, add, NEG_INF)

    # Stage 1.  int8 values are exact in bf16, so the bf16-query path loses
    # nothing on the corpus side; ``int8_queries`` quantizes the query too
    # (its scale folds into the epilogue as a per-query factor), adding
    # query-quantization error to stage 1 only — stage 2 re-ranks the m
    # candidates exactly in f32.
    q_i8 = q_scale = None
    if int8_queries:
        q_i8, q_scale = quantize_rows(q)
    adj1: jax.Array | None = None
    bmax: jax.Array | None = None
    if use_kernel:
        mode = stage1_mode(int8_queries, int4_packed)
        if q_i8 is not None:
            bmax = pallas_bmax(emb_i8, mult, add, q_i8, q_scale, mode=mode,
                               interpret=interpret)
        else:
            bmax = pallas_bmax(emb_i8, mult, add, q, jnp.ones((nq,)),
                               mode=mode, interpret=interpret)
    elif q_i8 is not None:
        acc = jax.lax.dot_general(
            q_i8, emb_i8,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32)                          # [Q, cap]
        adj1 = acc * (q_scale[:, None] * mult[None, :]) + add[None, :]
    else:
        acc = jax.lax.dot_general(
            q.astype(jnp.bfloat16), emb_i8.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                              # [Q, cap]
        adj1 = acc * mult[None, :] + add[None, :]
    if bf16_scores and adj1 is not None:
        # The cast fuses into the matmul epilogue, so only the bf16 matrix
        # ever reaches device memory.
        adj1 = adj1.astype(jnp.bfloat16)
    # NOTE: the L2 identity also carries a -(1-eta)*|q|^2 per-query column.
    # Stage-1 *values* are discarded below (both selection branches keep
    # only candidate indices, and stage 2 recomputes scores exactly), and a
    # per-query constant can't change within-query ranking — so the column
    # correction is deliberately omitted: one less [Q, cap] pass, and under
    # bf16 it would only push scores away from zero, costing mantissa.
    if blockmax_ok:
        # Hierarchical select (see docstring): [Q, cap] -> [Q, nb, 128]
        # max-reduce -> exact top-s over the [Q, nb] maxima -> expand each
        # winning sub-block to its 128 doc ids.  Padded rows carry NEG_INF
        # from the `add` fold, and stage 2 re-masks cand >= n_valid.
        nb = cap // BLOCKMAX_SUB
        # +2 margin blocks over the exact top-k guarantee absorb int8
        # stage-1 rank displacement past rank k; int4's coarser grid needs
        # double the margin.
        margin = 2 * (k + 2) if int4_grid else k + 2
        s = min(nb, max(margin, -(-m // BLOCKMAX_SUB)))
        if bmax is None:
            assert adj1 is not None
            bmax = jnp.max(adj1.reshape(nq, nb, BLOCKMAX_SUB), axis=-1)
        _, bid = jax.lax.top_k(bmax, s)                 # [Q, s]
        cand = (
            bid[:, :, None] * BLOCKMAX_SUB
            + jnp.arange(BLOCKMAX_SUB, dtype=bid.dtype)[None, None, :]
        ).reshape(nq, s * BLOCKMAX_SUB)                 # [Q, s*128]
        if nq > BLOCKMAX_REFINE_MAX_Q:
            # Large batches: block-granular refine traffic (s*128 D-dim
            # rows/query) outgrows the flat path's m rows.  Take the
            # winning blocks' stage-1 SCORES (s*128 scalars/query), top-m
            # within them, and row-gather only m docs — the same refine
            # traffic as the approx/flat paths, with selection that still
            # provably covers the stage-1 top-(k+2) margin.
            if adj1 is not None:
                cs = jnp.take_along_axis(
                    adj1.reshape(nq, nb, BLOCKMAX_SUB), bid[:, :, None],
                    axis=1,
                )
            else:
                cs = _block_scores(emb_i8, bid, q, q_i8, q_scale, mult, add,
                                   int4_packed)
            cs = cs.reshape(nq, s * BLOCKMAX_SUB).astype(jnp.float32)
            _, pos1 = jax.lax.top_k(cs, min(m, s * BLOCKMAX_SUB))
            cand = jnp.take_along_axis(cand, pos1, axis=1)
            ce, cp, csq = emb_f32[cand], payloads[cand], sqnorms[cand]
        else:
            # Block-granular refine gather: the candidates are s CONTIGUOUS
            # 128-doc blocks, so index the [nb, 128, D] view with the s
            # block ids — s sequential 128-row reads instead of s*128
            # arbitrary-row gathers.
            ce = emb_f32.reshape(nb, BLOCKMAX_SUB, emb_f32.shape[1])[bid]
            ce = ce.reshape(nq, s * BLOCKMAX_SUB, emb_f32.shape[1])
            cp = payloads.reshape(nb, BLOCKMAX_SUB, payloads.shape[1])[bid]
            cp = cp.reshape(nq, s * BLOCKMAX_SUB, payloads.shape[1])
            csq = sqnorms.reshape(nb, BLOCKMAX_SUB)[bid].reshape(nq, -1)
    elif approx_select and cap > max(4 * m, APPROX_SELECT_MIN_CAP):
        # Unsorted approximate candidate set (order fixed by the refine).
        # Only engaged at scale: below APPROX_SELECT_MIN_CAP the exact
        # top_k costs microseconds while approx_max_k's coarse reduction
        # can dip below the 0.99 recall gate on small corpora.
        assert adj1 is not None
        _, cand = jax.lax.approx_max_k(
            adj1, m, recall_target=0.95, aggregate_to_topk=False
        )
        ce, cp, csq = emb_f32[cand], payloads[cand], sqnorms[cand]
    else:
        assert adj1 is not None
        _, cand = jax.lax.top_k(adj1, m)                # [Q, m]
        ce, cp, csq = emb_f32[cand], payloads[cand], sqnorms[cand]

    # Stage 2: exact f32 over the gathered candidates only.
    sim2 = jnp.einsum("qd,qmd->qm", q, ce, preferred_element_type=jnp.float32,
                      precision=EXACT_PRECISION)
    if not normalize:
        sim2 = 2.0 * sim2 - csq - jnp.sum(q * q, -1, keepdims=True)
    adj2 = (
        (1.0 - eta) * sim2
        + eta * cp[..., 0]
        + entropy_pref * 0.5 * (cp[..., 1] + cp[..., 3])
    )
    cvalid = cand < n_valid
    adj2 = jnp.where(cvalid, adj2, NEG_INF)
    scores, pos = jax.lax.top_k(adj2, k)
    return scores, jnp.take_along_axis(cand, pos, axis=1)


__all__ = [
    "stage1_mode",
    "quantize_rows",
    "quantize_rows_int4",
    "unpack_int4",
    "quantized_search",
    "BLOCKMAX_SUB",
]
