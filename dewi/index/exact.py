"""Exact index: one fused matmul -> re-rank -> top-k XLA computation.

Replaces the reference's numpy brute force (backends.py:386-481) and — by
virtue of accelerator matmul throughput — also stands in for its
hnswlib/FAISS ANN tiers at exact recall.  Unlike the reference's pipeline of
normalize / dot / argpartition(2k) / python re-rank / argpartition(k) / sort,
the whole query is a single jitted kernel (ops/similarity.fused_search) whose
re-rank is exact over every document, not just a 2k over-fetch.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.similarity import fused_search
from ..types import Payload
from .base import BaseIndex


class ExactIndex(BaseIndex):
    """Brute-force cosine / L2 search with fused DEWI re-ranking.

    An f32 store is scored at ``EXACT_PRECISION``; a bf16 store
    (``mesh.dtype: bfloat16``) bf16 x bf16 with f32 accumulation.
    Selection defaults to hierarchical block-max (``blockmax_select``) —
    exact result values at every batch size, and the fix for the flat
    ``lax.top_k``'s collapse on large batches.  ``use_pallas`` /
    ``fused_bmax`` are accepted so indexes saved with them still load; no
    kernel runs on this tier.
    """

    def __init__(self, dim: int, space: str = "cosine",
                 blockmax_select: bool = True, **kwargs: Any) -> None:
        for legacy in ("use_pallas", "fused_bmax"):
            kwargs.pop(legacy, None)
        super().__init__(dim, space, **kwargs)
        # Hierarchical block-max selection over the FINAL adjusted scores —
        # exact result VALUES (see ops/similarity.fused_search docstring;
        # doc ids can differ from the flat top-k only on exact f32 score
        # ties), replacing the full [Q, cap] lax.top_k.
        self.blockmax_select = bool(blockmax_select)

    def _hyperparams(self) -> dict:
        return {"blockmax_select": self.blockmax_select}

    def _blockmax_ok(self) -> bool:
        from ..ops.quantized import BLOCKMAX_SUB

        cap = self.store.capacity
        return (
            self.blockmax_select
            and cap % BLOCKMAX_SUB == 0
            and cap >= 4 * BLOCKMAX_SUB
        )

    def build(self, **kwargs: Any) -> None:
        if len(self.store) == 0:
            raise ValueError("No embeddings to build index from")
        self.store.device_arrays()  # sync + normalize on device
        self._is_trained = True

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        eta: float = 0.5,
        entropy_pref: float = 0.0,
    ) -> Tuple[jax.Array, jax.Array]:
        """Batched device-native search: [Q, D] queries -> ([Q, k], [Q, k]).

        This is the hot path: everything from similarity to top-k runs in one
        XLA computation on the device; results stay on device.
        """
        emb, sqn, pay, n = self.store.device_arrays()
        q = jnp.atleast_2d(jnp.asarray(queries, dtype=jnp.float32))
        k_eff = min(int(k), self.store.capacity)
        return fused_search(
            emb,
            sqn,
            pay,
            q,
            n,
            jnp.float32(eta),
            jnp.float32(entropy_pref),
            k=k_eff,
            normalize=self.store.normalize,
            blockmax_select=self._blockmax_ok(),
        )

    def search(
        self,
        query: np.ndarray,
        k: int = 10,
        eta: float = 0.5,
        entropy_pref: float = 0.0,
    ) -> List[Tuple[str, float, Payload]]:
        """Single-query search returning (doc_id, adjusted_score, Payload).

        Result-shape parity with reference backends.py:414-481; at most
        ``len(self)`` results are returned (padding rows are masked to -inf
        inside the kernel and trimmed here).
        """
        if len(self.store) == 0:
            return []
        scores, idx = self.search_batch(query, k=k, eta=eta, entropy_pref=entropy_pref)
        scores = np.asarray(scores[0])
        idx = np.asarray(idx[0])
        pay = self.store.payload_matrix()
        n_live = min(int(k), len(self.store))
        results = []
        for rank in range(n_live):
            i = int(idx[rank])
            doc_id = self.store.doc_ids[i]
            results.append((doc_id, float(scores[rank]), Payload.from_array(pay[i])))
        return results
