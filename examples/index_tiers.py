#!/usr/bin/env python
"""DEWI index-tier ladder: exact -> bf16 -> int8 -> int4, one corpus.

Shows the latency/recall trade the backends expose and verifies every
tier against the exact ranking (the int tiers' two-stage refine keeps
recall >= 0.99 at a fraction of the stage-1 HBM read — int8 reads 1/4
of f32's bytes, int4 1/8).  Hermetic: synthetic embeddings, runs on CPU
or GPU:

    python examples/index_tiers.py

Backend name strings match the config surface (``IndexConfig.ann`` /
``DewiIndex(backend=...)``): "exact", "quantized"/"int8", "int4".
Reference analogue being replaced: hnswlib/FAISS tier selection
(reference src/dewi/backends.py:32-49).
"""

import os
import time

import numpy as np

from dewi import DewiIndex
from dewi.metrics import recall_matrix

N = int(os.environ.get("DEWI_EXAMPLE_DOCS", 4096))
D, K, NQ = 128, 10, 32


def main() -> None:
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    pay = np.abs(rng.normal(size=(N, 8))).astype(np.float32)
    pay[:, 0] = rng.beta(2, 2, N)  # dewi column in [0, 1]
    ids = [f"doc{i}" for i in range(N)]
    queries = rng.normal(size=(NQ, D)).astype(np.float32)

    results: dict[str, tuple[float, np.ndarray]] = {}
    for backend in ("exact", "int8", "int4"):
        idx = DewiIndex(dim=D, backend=backend)
        idx.add_batch(ids, emb, pay)
        idx.build()
        # np.asarray inside the timed region forces the async dispatch to
        # complete — without it the timer measures dispatch, not search.
        np.asarray(idx.search_batch(queries, k=K, eta=0.25,
                                    entropy_pref=0.1)[1])  # warm + sync
        t0 = time.perf_counter()
        _, got = idx.search_batch(queries, k=K, eta=0.25, entropy_pref=0.1)
        got = np.asarray(got)
        dt = (time.perf_counter() - t0) / NQ * 1e3
        results[backend] = (dt, got)

    exact_idx = results["exact"][1]
    print(f"{'backend':8s} {'ms/query':>9s} {'recall@10 vs exact':>19s}")
    for backend, (dt, got) in results.items():
        rec = float(recall_matrix(got, exact_idx))
        print(f"{backend:8s} {dt:9.3f} {rec:19.4f}")
        assert rec >= 0.99, (backend, rec)
    print("all tiers hold the >=0.99 recall gate")


if __name__ == "__main__":
    main()
