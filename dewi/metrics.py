"""Evaluation metrics for DEWI retrieval and analysis.

Behavior parity with the reference metrics library (reference
metrics.py:9-212): micro-averaged ``recall_at_k``, exponential-gain
``dcg_at_k`` / ``ndcg_at_k``, ``mrr``, DEWI-bin stratification with a
double-inclusive last bin, near-duplicate ``duplicate_rate`` and
``cluster_coverage``.

These run host-side over Python id mappings (the eval sets are small);
the array-native helpers at the bottom (``recall_matrix``,
``ndcg_matrix``) take ``[Q, k]`` retrieved-index matrices straight from
``DewiIndex.search_batch`` so recall-vs-exact sweeps stay on device
output without building id dicts.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Ranking metrics (id-based, host-side)
# ---------------------------------------------------------------------------


def recall_at_k(
    ground_truth: Dict[str, Sequence[str]],
    rankings: Dict[str, Sequence[str]],
    k: int = 10,
) -> float:
    """Micro-averaged recall@k: total hits / total relevant docs.

    Parity: reference metrics.py:9-36 (queries missing from ``rankings``
    contribute zero hits but their relevant docs still count in the
    denominator).
    """
    hits = 0
    for q, relevant in ground_truth.items():
        ranked = rankings.get(q)
        if ranked is None:
            continue
        hits += len(set(relevant) & set(ranked[:k]))
    denom = max(sum(len(docs) for docs in ground_truth.values()), 1)
    return hits / denom


def dcg_at_k(relevance_scores: Sequence[float]) -> float:
    """DCG with exponential gain ``(2^rel - 1) / log2(rank + 1)``.

    Parity: reference metrics.py:38-50.
    """
    rel = np.asarray(relevance_scores, dtype=np.float32)
    if rel.size == 0:
        return 0.0
    discounts = np.log2(np.arange(2, rel.size + 2, dtype=np.float32))
    return float(np.sum((np.exp2(rel) - 1.0) / discounts))


def ndcg_at_k(
    ground_truth: Dict[str, Dict[str, int]],
    rankings: Dict[str, Sequence[str]],
    k: int = 10,
) -> float:
    """Mean nDCG@k over queries present in both mappings.

    Parity: reference metrics.py:52-87 (ideal DCG from the top-k graded
    relevances; ``idcg=1.0`` when the query has no graded docs; epsilon
    in the denominator).
    """
    scores = []
    for q, rel_map in ground_truth.items():
        ranked = rankings.get(q)
        if ranked is None:
            continue
        gains = [rel_map.get(doc_id, 0) for doc_id in ranked[:k]]
        ideal = sorted(rel_map.values(), reverse=True)[:k]
        idcg = dcg_at_k(ideal) if ideal else 1.0
        scores.append(dcg_at_k(gains) / (idcg + 1e-8))
    return float(np.mean(scores)) if scores else 0.0


def mrr(
    ground_truth: Dict[str, Sequence[str]],
    rankings: Dict[str, Sequence[str]],
) -> float:
    """Mean reciprocal rank of the first relevant hit (0 if none).

    Parity: reference metrics.py:89-117.
    """
    rrs = []
    for q, relevant in ground_truth.items():
        ranked = rankings.get(q)
        if ranked is None:
            continue
        relevant_set = set(relevant)
        rr = 0.0
        for i, doc_id in enumerate(ranked, start=1):
            if doc_id in relevant_set:
                rr = 1.0 / i
                break
        rrs.append(rr)
    return float(np.mean(rrs)) if rrs else 0.0


# ---------------------------------------------------------------------------
# Entropy analysis
# ---------------------------------------------------------------------------


def stratify_by_dewi(
    bins: Sequence[float],
    doc_dewi: Dict[str, float],
    rankings: Dict[str, Sequence[str]],
) -> Dict[Tuple[float, float], float]:
    """Proportion of retrieved docs per DEWI bin.

    Parity: reference metrics.py:119-171 — half-open bins ``[lo, hi)``
    except the last, which is double-inclusive ``[lo, hi]``; docs missing
    from ``doc_dewi`` score 0.0; out-of-range docs count toward the total
    but land in no bin.
    """
    if not bins or len(bins) < 2:
        raise ValueError("At least two bin boundaries required")
    edges = list(bins)
    ranges = [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)]
    counts = {r: 0 for r in ranges}
    total = 0
    for docs in rankings.values():
        for doc_id in docs:
            val = doc_dewi.get(doc_id, 0.0)
            total += 1
            for i, (lo, hi) in enumerate(ranges):
                last = i == len(ranges) - 1
                if (lo <= val <= hi) if last else (lo <= val < hi):
                    counts[(lo, hi)] += 1
                    break
    if total == 0:
        return {r: 0.0 for r in ranges}
    return {r: c / total for r, c in counts.items()}


# ---------------------------------------------------------------------------
# Redundancy & diversity
# ---------------------------------------------------------------------------


def duplicate_rate(clusters: List[Sequence[str]]) -> float:
    """``1 - singletons/len(clusters)`` over near-duplicate clusters.

    Parity: reference metrics.py:173-191 (including its singleton-over-
    cluster-count convention and empty-input zeros).
    """
    if not clusters:
        return 0.0
    total_docs = sum(len(c) for c in clusters)
    if total_docs == 0:
        return 0.0
    singletons = sum(1 for c in clusters if len(c) == 1)
    return 1.0 - singletons / len(clusters)


def cluster_coverage(
    selected: Sequence[str],
    clusters: List[Sequence[str]],
) -> float:
    """Fraction of clusters containing at least one selected doc.

    Parity: reference metrics.py:193-212.
    """
    if not clusters:
        return 0.0
    sel = set(selected)
    covered = sum(1 for c in clusters if not sel.isdisjoint(c))
    return covered / len(clusters)


# ---------------------------------------------------------------------------
# Array-native variants (no reference counterpart — for device-output evals)
# ---------------------------------------------------------------------------


def recall_matrix(retrieved: np.ndarray, truth: np.ndarray) -> float:
    """Recall between two ``[Q, k]`` index matrices (e.g. IVF vs exact).

    Used by the recall-vs-exact acceptance sweep (BASELINE.md north-star:
    >=0.99 recall).  Rows are compared as sets; ordering is ignored.
    """
    retrieved = np.asarray(retrieved)
    truth = np.asarray(truth)
    if retrieved.shape[0] != truth.shape[0]:
        raise ValueError("Query counts differ")
    if truth.size == 0:
        return 0.0
    hits = sum(
        len(set(r.tolist()) & set(t.tolist()))
        for r, t in zip(retrieved, truth)
    )
    return hits / truth.size


@partial(jax.jit, static_argnames=("k", "normalize"))
def reference_topk(embeddings: Any, payloads: Any, queries: Any, k: int,
                   eta: Any, entropy_pref: Any,
                   normalize: bool = True) -> Tuple[Any, Any]:
    """Plain float32 ground truth for recall: ``([Q, k] scores, [Q, k] rows)``.

    Cosine (or negative squared L2) similarity at ``EXACT_PRECISION`` —
    a GPU would otherwise run the f32 matmul in TF32 — then the DEWI
    re-rank and a flat ``lax.top_k``.  Shares no code with the index tiers
    beyond :func:`~dewi.ops.similarity.rerank_scores`."""
    from .ops.similarity import EXACT_PRECISION, l2_normalize, rerank_scores

    emb = jnp.asarray(embeddings, jnp.float32)
    q = jnp.asarray(queries, jnp.float32)
    if normalize:
        sim = jnp.dot(l2_normalize(q), l2_normalize(emb).T,
                      precision=EXACT_PRECISION)
    else:
        sim = -(jnp.sum(q * q, -1)[:, None] + jnp.sum(emb * emb, -1)[None, :]
                - 2.0 * jnp.dot(q, emb.T, precision=EXACT_PRECISION))
    adj = rerank_scores(sim, jnp.asarray(payloads, jnp.float32), eta,
                        entropy_pref)
    return jax.lax.top_k(adj, k)


def mrr_matrix(retrieved: np.ndarray, first_relevant: np.ndarray) -> float:
    """MRR where ``first_relevant[q]`` is the single relevant row index."""
    retrieved = np.asarray(retrieved)
    first_relevant = np.asarray(first_relevant).reshape(-1, 1)
    q, k = retrieved.shape
    match = retrieved == first_relevant  # [Q, k]
    ranks = np.argmax(match, axis=1) + 1.0
    any_hit = match.any(axis=1)
    rr = np.where(any_hit, 1.0 / ranks, 0.0)
    return float(rr.mean()) if q else 0.0


__all__ = [
    "recall_at_k",
    "dcg_at_k",
    "ndcg_at_k",
    "mrr",
    "stratify_by_dewi",
    "duplicate_rate",
    "cluster_coverage",
    "recall_matrix",
    "reference_topk",
    "mrr_matrix",
]
