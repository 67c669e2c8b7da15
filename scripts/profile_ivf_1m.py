#!/usr/bin/env python
"""IVF recall + build at 1M CLUSTERED docs — the regime where buckets bite.

bench.py measures IVF recall on a 1M *random* corpus (trivially high with
the overflow tier) and a 200k clustered one; this script runs the missing
case (VERDICT r2 #4): 1M docs drawn from a Gaussian-mode mixture, where
cluster imbalance can overflow buckets and nprobe actually gates recall.

Ground truth is the fused exact search on the same store.  Reports cold
and warm build seconds, recall@10 at the default dials, and a small nprobe
sweep.  Writes one JSON (default perf_out/ivf_clustered_1m.json).

Usage:
  python scripts/profile_ivf_1m.py --n-docs 1000000 --modes 512
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-docs", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--modes", type=int, default=512,
                    help="Gaussian modes in the synthetic corpus")
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--output", default="perf_out/ivf_clustered_1m.json")
    args = ap.parse_args()

    import jax

    from dewi.utils.platform import apply_platform_override

    apply_platform_override()
    import jax.numpy as jnp
    from dewi.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from dewi.eval import recall_matrix
    from dewi.index.exact import ExactIndex
    from dewi.index.ivf import IVFIndex

    n, d, nc = args.n_docs, args.dim, args.modes
    print(f"Device: {jax.devices()[0]}", flush=True)
    kc1, kc2, kc3, kq1, kq2 = jax.random.split(jax.random.PRNGKey(7), 5)
    centers = jax.random.normal(kc1, (nc, d), jnp.float32) * 3.0
    # Imbalanced mode sizes (zipf-ish): the bucket-overflow stress case.
    w = 1.0 / (jnp.arange(nc) + 1.0)
    labels = jax.random.categorical(
        kc2, jnp.log(w / w.sum()), shape=(n,)
    )
    emb = centers[labels] + jax.random.normal(kc3, (n, d), jnp.float32)
    pay = jax.random.gamma(jax.random.PRNGKey(1), 2.0, (n, 8)).astype(
        jnp.float32
    )
    jax.block_until_ready(emb)
    ids = [str(i) for i in range(n)]
    queries = np.asarray(
        centers[jax.random.randint(kq1, (args.n_queries,), 0, nc)]
        + jax.random.normal(kq2, (args.n_queries, d), jnp.float32)
    )
    print("corpus ready", flush=True)

    metrics: dict = {
        "n_docs": n, "dim": d, "modes": nc, "mode_weights": "zipf",
        "nlist": args.nlist, "nprobe": args.nprobe, "k": args.k,
        "n_queries": args.n_queries, "device": str(jax.devices()[0]),
    }

    ivf = IVFIndex(dim=d, nlist=args.nlist, nprobe=args.nprobe,
                   dewi_tier=1024, kmeans_iters=8)
    ivf.store.attach_device(ids, emb, pay)
    t0 = time.perf_counter()
    ivf.build()
    jax.block_until_ready(ivf._dev[1])
    metrics["build_cold_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    ivf.build()
    jax.block_until_ready(ivf._dev[1])
    metrics["build_warm_s"] = round(time.perf_counter() - t0, 2)
    print(f"build: cold {metrics['build_cold_s']}s, "
          f"warm {metrics['build_warm_s']}s", flush=True)

    exact = ExactIndex(dim=d)
    exact.store.attach_device(ids, emb, pay)
    exact.build()

    def blocked(search_fn, qblock=128, **kw):
        outs = []
        for s in range(0, args.n_queries, qblock):
            _, idx = search_fn(queries[s : s + qblock], k=args.k, **kw)
            outs.append(np.asarray(idx))
        return np.concatenate(outs)

    gt = blocked(exact.search_batch)
    for nprobe in (8, 16, args.nprobe, 64):
        got = blocked(ivf.search_batch, nprobe=nprobe)
        r = float(recall_matrix(got, gt))
        metrics[f"recall_at_k{args.k}_nprobe{nprobe}"] = round(r, 4)
        print(f"nprobe={nprobe}: recall@{args.k} = {r:.4f}", flush=True)

    # Batched latency at the default dials, f32 vs bf16 bucket storage.
    def timed_ms_per_query():
        _ = blocked(ivf.search_batch)  # warm the (impl, shape) trace
        t0 = time.perf_counter()
        _ = blocked(ivf.search_batch)
        return round((time.perf_counter() - t0) / args.n_queries * 1e3, 4)

    metrics["batched_ms_per_query"] = timed_ms_per_query()
    print(f"f32: {metrics['batched_ms_per_query']} ms/query", flush=True)

    # bf16 bucket tier: half the probe HBM traffic; recall measured against
    # the same exact ground truth.
    ivf_bf = IVFIndex(dim=d, nlist=args.nlist, nprobe=args.nprobe,
                      dewi_tier=1024, kmeans_iters=8, probe_dtype="bf16")
    ivf_bf.store.attach_device(ids, emb, pay)
    ivf_bf.build()
    jax.block_until_ready(ivf_bf._dev[1])
    got = blocked(ivf_bf.search_batch)
    metrics[f"recall_at_k{args.k}_bf16"] = round(
        float(recall_matrix(got, gt)), 4
    )
    ivf = ivf_bf
    metrics["batched_ms_per_query_bf16"] = timed_ms_per_query()
    print(f"bf16: {metrics['batched_ms_per_query_bf16']} ms/query",
          flush=True)
    print(f"bf16 recall: {metrics[f'recall_at_k{args.k}_bf16']}", flush=True)

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
