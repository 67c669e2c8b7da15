"""Compute kernels: robust stats, fused similarity/re-rank/top-k, k-means."""

from .robust import (
    MAD_CONSISTENCY,
    local_weights_kernel,
    masked_mean_and_quantiles,
    median_mad,
    quantiles,
    robust_z,
)
from .similarity import (
    fused_search,
    l2_normalize,
    pairwise_cosine,
    rerank_scores,
    topk_merge,
)

__all__ = [
    "MAD_CONSISTENCY",
    "median_mad",
    "robust_z",
    "quantiles",
    "masked_mean_and_quantiles",
    "local_weights_kernel",
    "l2_normalize",
    "fused_search",
    "rerank_scores",
    "topk_merge",
    "pairwise_cosine",
]
