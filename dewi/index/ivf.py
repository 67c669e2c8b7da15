"""IVF index: k-means coarse quantizer + probed fixed-size buckets.

Replacement for FAISS IVFFlat (reference backends.py:287-293,
326-355).  The design differs from FAISS's variable-length inverted lists,
which don't map to XLA's static shapes:

* clusters are materialized as fixed-capacity buckets
  ``[nlist, bucket_cap, D]`` so a probe is a static-shape gather + matmul;
* docs that overflow a bucket go to a dense *overflow tier* that every query
  scans exactly — so imbalanced clusters cost a little compute, never recall;
* search = centroid matmul -> top-nprobe -> bucket gather -> fused DEWI
  re-rank -> top-k, all in one jitted call per query block.

Recall misses can come only from unprobed (non-overflow) buckets, matching
classic IVF semantics with nprobe as the recall/latency dial.
"""

from __future__ import annotations

from functools import partial
from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.kmeans import assign_clusters, assign_clusters_top2, kmeans
from ..ops.similarity import l2_normalize, rerank_scores
from ..types import Payload
from .base import BaseIndex

NEG_INF = float("-inf")  # python float: no backend init at import time
QUERY_BLOCK = 64


@partial(jax.jit, static_argnames=("k", "nprobe", "normalize", "dedup"))
def _ivf_search_kernel(
    centroids: jax.Array,     # [nlist, D]
    b_emb: jax.Array,         # [nlist, cap, D] (f32 or bf16)
    b_pay: jax.Array,         # [nlist, cap, 8]
    b_valid: jax.Array,       # [nlist, cap] bool
    b_docidx: jax.Array,      # [nlist, cap] int32 (-1 pad)
    b_sqn: jax.Array,         # [nlist, cap]
    o_emb: jax.Array,         # [o_cap, D]
    o_pay: jax.Array,         # [o_cap, 8]
    o_docidx: jax.Array,      # [o_cap]
    o_sqn: jax.Array,         # [o_cap]
    o_n: jax.Array,           # scalar int32
    queries: jax.Array,       # [Q, D]
    eta: jax.Array,
    entropy_pref: jax.Array,
    k: int,
    nprobe: int,
    normalize: bool,
    dedup: bool = False,
) -> tuple[jax.Array, jax.Array]:
    q = queries.astype(jnp.float32)
    if normalize:
        q = l2_normalize(q)
        csim = jnp.dot(
            q, centroids.astype(jnp.float32).T,
            preferred_element_type=jnp.float32,
        )
    else:
        c32 = centroids.astype(jnp.float32)
        cn = jnp.sum(c32 * c32, axis=1)
        csim = 2.0 * jnp.dot(q, c32.T, preferred_element_type=jnp.float32) - cn[None, :]
    # Empty buckets (clusters with no members, or the zero-centroid padding
    # the sharded searcher appends to split evenly) must not win probe
    # slots: their centroid similarity of ~0 can outrank real centroids
    # when every true similarity is negative, silently shrinking the
    # effective probe budget.
    nonempty = jnp.any(b_valid, axis=1)
    csim = jnp.where(nonempty[None, :], csim, NEG_INF)
    _, probes = jax.lax.top_k(csim, nprobe)  # [Q, nprobe]

    qe = q.astype(b_emb.dtype)  # match bucket storage (bf16 halves HBM reads)
    qn = jnp.sum(q * q, axis=-1)

    def _scores_from(ps: jax.Array, pp: jax.Array, pv: jax.Array,
                     dots: jax.Array) -> jax.Array:
        if normalize:
            sim = dots
        else:
            extra = qn[:, None, None] if dots.ndim == 3 else qn[:, None]
            sim = 2.0 * dots - ps - extra
        adj = (
            (1.0 - eta) * sim
            + eta * pp[..., 0]
            + entropy_pref * 0.5 * (pp[..., 1] + pp[..., 3])
        )
        return jnp.where(pv, adj, NEG_INF)

    nq = q.shape[0]

    # Stream the probed buckets one probe rank at a time: each step gathers
    # only [Q, cap, D] and feeds it straight into the einsum, so device
    # memory never holds (or re-reads) a [Q, nprobe, cap, D] block.
    def step(_: Any, pj: jax.Array) -> Any:   # pj: [Q] bucket ids
        pe = b_emb[pj]                     # [Q, cap, D]
        dots = jnp.einsum(
            "qd,qcd->qc", qe, pe, preferred_element_type=jnp.float32
        )
        adj = _scores_from(b_sqn[pj], b_pay[pj], b_valid[pj], dots)
        return None, (adj, b_docidx[pj])
    _, (adjs, idxs) = jax.lax.scan(step, None, probes.T)
    # [nprobe, Q, cap] -> [Q, nprobe * cap]
    flat_scores = adjs.transpose(1, 0, 2).reshape(nq, -1)
    flat_idx = idxs.transpose(1, 0, 2).reshape(nq, -1)

    # Overflow tier: always scanned exactly (in the bucket storage dtype).
    qo = q.astype(o_emb.dtype)
    if normalize:
        osim = jnp.dot(qo, o_emb.T, preferred_element_type=jnp.float32)
    else:
        osim = (
            2.0 * jnp.dot(qo, o_emb.T, preferred_element_type=jnp.float32)
            - o_sqn[None, :]
            - jnp.sum(q * q, axis=-1, keepdims=True)
        )
    oadj = rerank_scores(osim, o_pay, eta, entropy_pref)
    # Mask both by count and by docidx validity: sharded layouts pass padded
    # overflow slices whose invalid slots are only marked by docidx == -1.
    ovalid = (
        jnp.arange(o_emb.shape[0], dtype=jnp.int32)[None, :] < o_n
    ) & (o_docidx >= 0)[None, :]
    oadj = jnp.where(ovalid, oadj, NEG_INF)

    all_scores = jnp.concatenate([flat_scores, oadj], axis=1)
    all_idx = jnp.concatenate(
        [flat_idx, jnp.broadcast_to(o_docidx[None, :], oadj.shape)], axis=1
    )
    if not dedup:
        vals, pos = jax.lax.top_k(all_scores, k)
        return vals, jnp.take_along_axis(all_idx, pos, axis=1)
    # Spill-built indexes (spill_frac > 0) can surface the same doc from two
    # buckets with IDENTICAL scores (the copies are bit-equal); both slots
    # entering the top-k would displace a distinct doc.  Take top-2k, kill
    # every later occurrence of a repeated id, re-select k.  The [Q, 2k, 2k]
    # mask is a few kB — noise next to the probe matmuls.
    kk = min(2 * k, all_scores.shape[1])
    vals, pos = jax.lax.top_k(all_scores, kk)
    ids = jnp.take_along_axis(all_idx, pos, axis=1)          # [Q, kk]
    vals_k, ids_k = _dedup_topk(vals, ids, k)
    return vals_k, ids_k


def _dedup_topk(vals: jax.Array, ids: jax.Array,
                k: int) -> tuple[jax.Array, jax.Array]:
    """Kill every later occurrence of a repeated id, re-select top-k.

    ``vals``/``ids`` are score-descending candidate rows (e.g. a top-2k).
    Duplicate slots get score -inf AND id -1 — the -1 matches the
    exhausted-pool sentinel the non-dedup paths produce, so downstream
    consumers (IVFIndex.search's ``i < 0`` skip, the sharded merge) treat
    a deduped slot exactly like an empty one instead of returning the
    same document twice."""
    kk = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]                  # [Q, j, l]
    earlier = jnp.tril(jnp.ones((kk, kk), bool), -1)         # l < j
    is_dup = jnp.any(eq & earlier[None], axis=2) & (ids >= 0)
    vals = jnp.where(is_dup, NEG_INF, vals)
    ids = jnp.where(is_dup, -1, ids)
    vals_k, pos_k = jax.lax.top_k(vals, min(k, kk))
    return vals_k, jnp.take_along_axis(ids, pos_k, axis=1)


@partial(jax.jit, static_argnames=("nlist", "cap", "tier_n"))
def _ivf_plan(
    assign: jax.Array,   # [Nx] int32 cluster ids (Nx >= N with spill copies)
    pay: jax.Array,      # [N, 8] ORIGINAL payloads (col 0 = dewi)
    doc_of: jax.Array,   # [Nx] int32: original doc id of each entry
    nlist: int,
    cap: int,
    tier_n: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Device-side bucket planning: stable sort by cluster, within-cluster
    rank, and the in-bucket mask (entries past ``cap`` or in the high-DEWI
    tier go to the exact overflow scan).  Spill copies (``doc_of`` repeats)
    plan like any other entry; the tier is picked over ORIGINAL docs so a
    tiered doc's every copy routes to the overflow scan."""
    n = assign.shape[0]
    order = jnp.argsort(assign, stable=True)          # [Nx]
    sorted_assign = assign[order]
    counts = jnp.bincount(assign, length=nlist)
    starts = jnp.concatenate(
        [jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]]
    )
    rank = jnp.arange(n) - starts[sorted_assign]      # [Nx] rank in cluster
    in_bucket = rank < cap
    if tier_n > 0:
        # The query-independent part of the adjusted score is
        # eta*dewi + entropy_pref*0.5*(ht_mean + hi_mean); eta/entropy_pref
        # are query-time knobs, so the tier must cover the leaders of BOTH
        # components — docs extreme in either can leapfrog into the global
        # top-k without similarity, and the coarse quantizer has no reason
        # to probe them.
        _, dewi_idx = jax.lax.top_k(pay[:, 0], tier_n)
        _, ent_idx = jax.lax.top_k(0.5 * (pay[:, 1] + pay[:, 3]), tier_n)
        is_tier = (
            jnp.zeros((pay.shape[0],), bool)
            .at[dewi_idx].set(True).at[ent_idx].set(True)
        )
        in_bucket &= ~is_tier[doc_of[order]]
    return order, rank, in_bucket


@partial(jax.jit, static_argnames=("nlist", "cap", "o_cap", "emb_dtype"))
def _ivf_materialize(
    emb: jax.Array,      # [N, D] ORIGINAL embeddings
    sqn: jax.Array,
    pay: jax.Array,
    order: jax.Array,    # [Nx] sorted entry positions
    rank: jax.Array,
    in_bucket: jax.Array,
    assign: jax.Array,   # [Nx]
    doc_of: jax.Array,   # [Nx] original doc id per entry
    nlist: int,
    cap: int,
    o_cap: int,
    emb_dtype: Any = jnp.float32,
) -> Tuple[jax.Array, ...]:
    """Scatter the planned layout into fixed-shape bucket + overflow arrays,
    all on device (scatters route rejected docs to a trash row/slot that is
    sliced away).  ``b_docidx``/``o_docidx`` store ORIGINAL doc ids, so a
    spill copy gathers the same row as its primary and search results
    reference one canonical id (deduped in the search kernel)."""
    sorted_assign = assign[order]
    src = doc_of[order].astype(jnp.int32)             # [Nx] original ids
    dest_row = jnp.where(in_bucket, sorted_assign, nlist)
    dest_col = jnp.where(in_bucket, jnp.minimum(rank, cap - 1), 0)
    b_docidx = (
        jnp.full((nlist + 1, cap), -1, jnp.int32)
        .at[dest_row, dest_col].set(src)
    )[:nlist]

    # Pack overflow docs densely: position = running count of overflow rows.
    is_over = ~in_bucket
    pos = jnp.cumsum(is_over) - 1
    o_dest = jnp.where(is_over, pos, o_cap)
    o_docidx = (
        jnp.full((o_cap + 1,), -1, jnp.int32)
        .at[o_dest].set(src)
    )[:o_cap]

    b_valid = b_docidx >= 0
    gather = jnp.clip(b_docidx, 0, None)
    # Bucket/overflow copies are storage the index owns — bf16 halves their
    # HBM footprint AND every probe's read traffic; sqn stays f32 (computed
    # from the f32 source, more accurate than re-deriving from bf16).
    b_emb = jnp.where(b_valid[..., None], emb[gather], 0.0).astype(emb_dtype)
    b_pay = jnp.where(b_valid[..., None], pay[gather], 0.0)
    b_sqn = jnp.where(b_valid, sqn[gather], 0.0)

    o_valid = o_docidx >= 0
    og = jnp.clip(o_docidx, 0, None)
    o_emb = jnp.where(o_valid[..., None], emb[og], 0.0).astype(emb_dtype)
    o_pay = jnp.where(o_valid[..., None], pay[og], 0.0)
    o_sqn = jnp.where(o_valid, sqn[og], 0.0)
    return (b_emb, b_pay, b_valid, b_docidx, b_sqn), (
        o_emb, o_pay, o_docidx, o_sqn,
    )


class IVFIndex(BaseIndex):
    """Inverted-file index over k-means buckets with an exact overflow tier."""

    def __init__(
        self,
        dim: int,
        space: str = "cosine",
        nlist: int = 100,
        nprobe: int = 8,
        bucket_load_factor: float = 1.5,
        kmeans_iters: int = 10,
        train_sample: int = 100_000,
        dewi_tier: int = 1024,
        seed: int = 0,
        probe_dtype: str = "float32",
        spill_frac: float = 0.0,
        **kwargs: Any,
    ) -> None:
        # Indexes saved with the retired probe layout switch still load: the
        # probe always streams one rank at a time.
        kwargs.pop("probe_impl", None)
        super().__init__(dim, space, **kwargs)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.bucket_load_factor = float(bucket_load_factor)
        self.kmeans_iters = int(kmeans_iters)
        self.train_sample = int(train_sample)
        # Bucket/overflow storage dtype: "bfloat16" halves probe HBM traffic
        # (recall impact mirrors the bf16 exact tier: 1.0 at k=10 measured);
        # "float32" keeps stage scores bit-identical to the exact tier;
        # "auto" follows the store's embedding dtype at build time (a bf16
        # store never upcasts its bucket copies back to f32).
        aliases = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32"}
        self.probe_dtype = aliases.get(str(probe_dtype), str(probe_dtype))
        if self.probe_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                "probe_dtype must be auto|float32|bfloat16, "
                f"got {probe_dtype!r}")
        # DEWI-specific recall guard: the adjusted score mixes in eta*dewi,
        # so at high eta the global ranking is dominated by documents the
        # coarse quantizer has no reason to probe.  The ``dewi_tier`` docs
        # with the highest DEWI scores are therefore routed to the exact
        # overflow scan (always searched), bounding the eta-induced recall
        # loss regardless of nprobe.  No reference counterpart — FAISS/HNSW
        # in the reference re-rank only retrieved candidates and silently
        # miss global DEWI leaders (backends.py:217-240, 326-355).
        self.dewi_tier = int(dewi_tier)
        # Doc-side boundary spill (ScaNN-SOAR / FAISS-spill style): the
        # ``spill_frac`` fraction of docs with the smallest top-2 centroid
        # margin are ALSO written into their second-closest bucket.  Probe
        # misses concentrate exactly there — a boundary query's nprobe set
        # covers the boundary's both sides only if the doc does too
        # (scripts/profile_ivf_recall_curve.py measures boundary-family
        # recall with and without spill).  Costs spill_frac extra
        # bucket storage/probe read; duplicates are deduped at top-k.
        self.spill_frac = float(spill_frac)
        if not 0.0 <= self.spill_frac <= 1.0:
            raise ValueError(f"spill_frac must be in [0, 1], got {spill_frac}")
        self.seed = int(seed)
        self._dev = None

    def _hyperparams(self) -> dict:
        return {
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "bucket_load_factor": self.bucket_load_factor,
            "kmeans_iters": self.kmeans_iters,
            "train_sample": self.train_sample,
            "dewi_tier": self.dewi_tier,
            "seed": self.seed,
            "probe_dtype": self.probe_dtype,
            "spill_frac": self.spill_frac,
        }

    # -- build -------------------------------------------------------------

    def build(self, **kwargs: Any) -> None:
        """Bucketize the corpus entirely on device.

        k-means, cluster assignment, stable sort, per-cluster ranking, the
        high-DEWI tier pick, and all bucket/overflow gathers are jitted XLA
        scatter/gather programs; the only host sync is the scalar overflow
        count (needed to pick a static overflow capacity).  Nothing corpus-
        sized crosses the host boundary — the reference's FAISS train path
        (backends.py:287-293) and round-1's numpy bucketization both pulled
        the full corpus to host RAM (~1 GB at 1M x 256)."""
        n = len(self.store)
        if n == 0:
            raise ValueError("No embeddings to build index from")
        emb_dev, sqn_dev, pay_dev, _ = self.store.device_arrays()
        emb = emb_dev[:n]
        sqn = sqn_dev[:n]
        pay = pay_dev[:n]

        nlist = min(self.nlist, n)
        key = jax.random.PRNGKey(self.seed)
        if n > self.train_sample:
            sample_idx = jax.random.choice(key, n, (self.train_sample,), replace=False)
            train = emb[sample_idx]
        else:
            train = emb
        centroids, _ = kmeans(
            train, key, n_clusters=nlist, n_iters=self.kmeans_iters,
            spherical=self.store.normalize,
        )
        n_spill = (
            int(round(self.spill_frac * n)) if nlist >= 2 else 0
        )
        if n_spill > 0:
            a2, margin = assign_clusters_top2(emb, centroids)
            assign = a2[:, 0]
            # Smallest-margin docs sit on cluster boundaries; copy them
            # into their runner-up bucket.
            _, spill_idx = jax.lax.top_k(-margin, n_spill)
            spill_idx = spill_idx.astype(jnp.int32)
            assign_x = jnp.concatenate([assign, a2[spill_idx, 1]])
            doc_of = jnp.concatenate(
                [jnp.arange(n, dtype=jnp.int32), spill_idx]
            )
        else:
            assign_x = assign_clusters(emb, centroids)  # [N] int32, device
            doc_of = jnp.arange(n, dtype=jnp.int32)

        n_eff = n + n_spill  # spill copies share the bucket budget
        cap = max(8, int(np.ceil(
            self.bucket_load_factor * max(1, n_eff / nlist) / 8.0)) * 8)
        tier_n = min(self.dewi_tier, n)

        order, rank, in_bucket = _ivf_plan(
            assign_x, pay, doc_of, nlist=nlist, cap=cap, tier_n=tier_n
        )
        # The one host sync: overflow count -> static overflow capacity.
        o_n = int(jnp.sum(~in_bucket))
        o_cap = max(8, -(-max(o_n, 1) // 8) * 8)

        probe_dtype = self.probe_dtype
        if probe_dtype == "auto":
            probe_dtype = (
                "bfloat16" if emb.dtype == jnp.bfloat16 else "float32"
            )
        b_arrays, o_arrays = _ivf_materialize(
            emb, sqn, pay, order, rank, in_bucket, assign_x, doc_of,
            nlist=nlist, cap=cap, o_cap=o_cap,
            emb_dtype=jnp.dtype(probe_dtype).name,
        )
        self._dev = (
            centroids.astype(jnp.float32),
            *b_arrays,
            *o_arrays,
            jnp.int32(o_n),
        )
        self._built_len = len(self.store)
        self._is_trained = True

    # -- search ---------------------------------------------------------------

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        eta: float = 0.5,
        entropy_pref: float = 0.0,
        nprobe: Optional[int] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        if self._dev is None or getattr(self, "_built_len", -1) != len(
            self.store
        ):
            # Docs added since build() are not in any bucket — rebuild.
            self.build()
        nprobe = min(int(nprobe or self.nprobe), min(self.nlist, len(self.store)))
        q = jnp.atleast_2d(jnp.asarray(queries, dtype=jnp.float32))
        # The candidate pool is nprobe buckets + the overflow tier — a k
        # beyond that (e.g. k=corpus on a small index) must clamp to the
        # pool, not the corpus, or top_k sees k > its axis.
        pool = nprobe * int(self._dev[1].shape[1]) + int(self._dev[6].shape[0])
        k_eff = min(int(k), len(self.store), pool)

        # Bound the probe working set to ~1 GB so 1M-doc corpora with large
        # buckets don't OOM the device: the scan path holds one probe rank
        # ([block, cap, D]) live at a time.
        b_emb = self._dev[1]
        bucket_cap = int(b_emb.shape[1])
        itemsize = int(jnp.dtype(b_emb.dtype).itemsize)
        bytes_per_q = bucket_cap * self.dim * itemsize
        block_size = max(1, min(QUERY_BLOCK, (1 << 30) // max(bytes_per_q, 1)))

        outs_v, outs_i = [], []
        for start in range(0, q.shape[0], block_size):
            block = q[start : start + block_size]
            v, i = _ivf_search_kernel(
                *self._dev,
                block,
                jnp.float32(eta),
                jnp.float32(entropy_pref),
                k=k_eff,
                nprobe=nprobe,
                normalize=self.store.normalize,
                # Spill-built buckets can hold two copies of one doc.
                dedup=self.spill_frac > 0.0,
            )
            outs_v.append(v)
            outs_i.append(i)
        return jnp.concatenate(outs_v, axis=0), jnp.concatenate(outs_i, axis=0)

    def search(
        self,
        query: np.ndarray,
        k: int = 10,
        eta: float = 0.5,
        entropy_pref: float = 0.0,
    ) -> List[Tuple[str, float, Payload]]:
        if len(self.store) == 0:
            return []
        scores, idx = self.search_batch(query, k=k, eta=eta, entropy_pref=entropy_pref)
        scores = np.asarray(scores[0])
        idx = np.asarray(idx[0])
        pay = self.store.payload_matrix()
        results = []
        for rank in range(min(int(k), idx.shape[0])):
            i = int(idx[rank])
            if i < 0:
                continue
            results.append(
                (self.store.doc_ids[i], float(scores[rank]), Payload.from_array(pay[i]))
            )
        return results
