#!/usr/bin/env python
"""Index build + search benchmark with the reference's measurement protocol.

Protocol parity with the reference profiler (reference
scripts/profile_index.py:241-254): defaults n_docs=100_000, dim=256,
n_queries=1000, k=10; seeded gamma/beta synthetic payload distributions
(profile_index.py:34-72); emits a ``metrics.json`` with docs/sec, QPS and
latency stats (profile_index.py:288-291).

Device-side measurement replaces cProfile: wall-clock timings around
``jax.block_until_ready`` plus optional ``jax.profiler`` XLA traces
(``--trace-dir`` -> TensorBoard-compatible trace instead of .prof dumps).

Usage:
  python scripts/profile_index.py --n-docs 100000 --dim 256 --backend exact
  python scripts/profile_index.py --backend ivf --nlist 256 --nprobe 16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def generate_synthetic_data(n_docs: int, dim: int, seed: int = 42,
                            clustered: bool = False, n_clusters: int = 256):
    """Seeded synthetic corpus: unit-ish embeddings + gamma/beta payloads
    (distribution parity: reference profile_index.py:34-72).

    ``clustered=True`` draws a mixture of Gaussians instead of isotropic
    noise — isotropic random vectors have near-uniform pairwise cosine, the
    pathological case for any IVF (recall ~ nprobe/nlist); real embedding
    corpora are clustered, which is what IVF exploits."""
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 3.0
        assign = rng.integers(0, n_clusters, n_docs)
        embeddings = (
            centers[assign] + rng.normal(size=(n_docs, dim))
        ).astype(np.float32)
    else:
        embeddings = rng.normal(size=(n_docs, dim)).astype(np.float32)
    payloads = np.empty((n_docs, 8), dtype=np.float32)
    payloads[:, 0] = rng.beta(2, 2, n_docs)          # dewi
    payloads[:, 1] = rng.gamma(2.0, 1.5, n_docs)     # ht_mean
    payloads[:, 2] = rng.gamma(2.5, 1.5, n_docs)     # ht_q90
    payloads[:, 3] = rng.gamma(2.0, 1.0, n_docs)     # hi_mean
    payloads[:, 4] = rng.gamma(2.5, 1.0, n_docs)     # hi_q90
    payloads[:, 5] = rng.beta(2, 5, n_docs)          # I_hat
    payloads[:, 6] = rng.beta(1, 4, n_docs)          # redundancy
    payloads[:, 7] = rng.beta(1, 9, n_docs)          # noise
    doc_ids = [str(i) for i in range(n_docs)]
    return doc_ids, embeddings, payloads


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--backend", default="exact", choices=["exact", "ivf", "quantized"])
    ap.add_argument("--nlist", type=int, default=256)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--eta", type=float, default=0.25)
    ap.add_argument("--entropy-pref", type=float, default=0.0)
    ap.add_argument("--latency-samples", type=int, default=200)
    ap.add_argument("--output", default="profile_metrics.json")
    ap.add_argument("--trace-dir", default=None,
                    help="Write a jax.profiler trace here (TensorBoard format)")
    ap.add_argument("--clustered", action="store_true",
                    help="Mixture-of-Gaussians corpus (realistic for IVF)")
    args = ap.parse_args()

    import jax

    from dewi.utils.platform import apply_platform_override

    apply_platform_override()

    from dewi.index import DewiIndex

    print(f"Device: {jax.devices()[0]}")
    print(f"Generating {args.n_docs} docs (dim={args.dim})...")
    doc_ids, emb, pay = generate_synthetic_data(
        args.n_docs, args.dim, clustered=args.clustered
    )
    qrng = np.random.default_rng(7)
    if args.clustered:
        # Realistic queries resemble corpus points (noisy copies), not
        # isotropic noise landing between clusters.
        picks = qrng.integers(0, args.n_docs, args.n_queries)
        queries = (
            emb[picks] + 0.3 * qrng.normal(size=(args.n_queries, args.dim))
        ).astype(np.float32)
    else:
        queries = qrng.normal(
            size=(args.n_queries, args.dim)
        ).astype(np.float32)

    kwargs = {}
    if args.backend == "ivf":
        kwargs = {"nlist": args.nlist, "nprobe": args.nprobe}
    index = DewiIndex(dim=args.dim, backend=args.backend, **kwargs)

    t0 = time.perf_counter()
    index.add_batch(doc_ids, emb, pay)
    index.build()
    s, _ = index.search_batch(queries[:1], k=args.k)  # force build sync
    jax.block_until_ready(s)
    build_s = time.perf_counter() - t0
    print(f"Build: {build_s:.2f}s ({args.n_docs / build_s:,.0f} docs/sec)")

    def run_queries():
        lat = []
        for i in range(min(args.latency_samples, args.n_queries)):
            t = time.perf_counter()
            s, _ = index.search_batch(
                queries[i : i + 1], k=args.k, eta=args.eta,
                entropy_pref=args.entropy_pref,
            )
            jax.block_until_ready(s)
            lat.append((time.perf_counter() - t) * 1e3)
        return lat

    # Warmup compile, then measure.
    run_queries_warm = index.search_batch(queries[:1], k=args.k, eta=args.eta,
                                          entropy_pref=args.entropy_pref)
    jax.block_until_ready(run_queries_warm[0])

    if args.trace_dir:
        with jax.profiler.trace(args.trace_dir):
            latencies = run_queries()
        print(f"XLA trace written to {args.trace_dir}")
    else:
        latencies = run_queries()

    t0 = time.perf_counter()
    s, _ = index.search_batch(queries, k=args.k, eta=args.eta,
                              entropy_pref=args.entropy_pref)
    jax.block_until_ready(s)
    batch_s = time.perf_counter() - t0

    metrics = {
        "backend": args.backend,
        "clustered_corpus": bool(args.clustered),
        "n_docs": args.n_docs,
        "dim": args.dim,
        "n_queries": args.n_queries,
        "k": args.k,
        "build_seconds": round(build_s, 3),
        "docs_per_sec": round(args.n_docs / build_s, 1),
        "queries_per_sec": round(args.n_queries / batch_s, 1),
        "mean_latency_ms": round(float(np.mean(latencies)), 4),
        "p50_latency_ms": round(float(np.percentile(latencies, 50)), 4),
        "p99_latency_ms": round(float(np.percentile(latencies, 99)), 4),
        "device": str(jax.devices()[0]),
    }
    if args.backend in ("ivf", "quantized"):
        from dewi.metrics import recall_matrix

        exact = DewiIndex(dim=args.dim, backend="exact")
        exact.add_batch(doc_ids, emb, pay)
        exact.build()
        nq = min(100, args.n_queries)
        _, ivf_idx = index.search_batch(queries[:nq], k=args.k, eta=args.eta,
                                        entropy_pref=args.entropy_pref)
        _, ex_idx = exact.search_batch(queries[:nq], k=args.k, eta=args.eta,
                                       entropy_pref=args.entropy_pref)
        metrics["recall_vs_exact"] = round(
            recall_matrix(np.asarray(ivf_idx), np.asarray(ex_idx)), 4
        )

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
