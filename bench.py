#!/usr/bin/env python
"""DEWI benchmark: 1M-doc build, every index tier, recall, and signals.

Protocol follows the reference's measurement script defaults
(reference scripts/profile_index.py:241-254: dim=256, n_queries=1000, k=10)
at the 1M-doc headline scale (reference README.md:163: 2.1 hr build, 22 ms
query on 16-core CPU + V100).

Latency: the warm median of single ``search_batch`` dispatches (Q=1), each
ended by ``block_until_ready``, on the host clock.  Batched throughput runs
all queries in one call.

Sections (DEWI_BENCH_SECTIONS=comma list; default all at 1M scale,
"core,recall" below 100k so the CI smoke stays fast):
  core    — build + f32/bf16 exact p50 + batched QPS
  int8    — quantized-tier p50 (bf16 and int8 queries)
  int4    — int4-packed two-stage tier (half the stage-1 stream)
  recall  — 1000-query recall vs the HIGHEST-precision f32 reference at
            k=10 and k=100
  ivf     — IVF build, batched latency + recall on a clustered corpus
  signals — small-preset signal backbones (docs/sec) + the redundancy pass

Emission protocol (a timeout must never erase the run): the result
JSON line is (re)printed after EVERY completed section, each time with
everything measured so far; the LAST line printed is authoritative.  A
SIGTERM/SIGALRM triggers a final best-effort emission.
DEWI_BENCH_TIME_BUDGET_S (default 1140 s) is a soft deadline: once
exceeded, remaining sections are skipped and recorded in
extras.skipped_sections.

Line format:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N, ...extras}
vs_baseline is the speedup over the reference's 22 ms 1M-doc query latency.
"""

import json
import os
import signal
import statistics
import sys
import time

import numpy as np

# Env overrides keep the benchmark CI-smokeable (tiny shapes on CPU).
N_DOCS = int(os.environ.get("DEWI_BENCH_N_DOCS", 1_000_000))
DIM = int(os.environ.get("DEWI_BENCH_DIM", 256))
N_QUERIES = int(os.environ.get("DEWI_BENCH_N_QUERIES", 1_000))
K = 10
ETA, EP = 0.25, 0.1
REPS = int(os.environ.get("DEWI_BENCH_REPS", 30))
BASELINE_QUERY_MS = 22.0         # reference README.md:163
BASELINE_BUILD_S = 2.1 * 3600.0  # reference README.md:163

_default_sections = (
    "core,int8,int4,recall,ivf,signals" if N_DOCS >= 100_000
    else "core,recall"
)
SECTIONS = set(
    os.environ.get("DEWI_BENCH_SECTIONS", _default_sections).split(",")
)


def main() -> None:
    import jax

    plat = os.environ.get("DEWI_BENCH_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
    from dewi.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp

    from dewi.index import DewiIndex
    from dewi.metrics import recall_matrix, reference_topk
    from dewi.scorer import DewiScorer

    dev = jax.devices()[0]
    extras: dict = {
        "latency_method": f"warm median of {REPS} single dispatches ended "
                          "by block_until_ready (host clock)",
        "n_docs": N_DOCS,
        "dim": DIM,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }

    # ---- incremental-emission machinery ----------------------------------
    # The headline is the fastest tier whose measured recall vs the f32
    # reference over the full query set meets the >=0.99 gate.  Candidates
    # register as (label, p50_ms, recall_extras_key); None means
    # exact-by-construction (recall 1.0).
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("DEWI_BENCH_TIME_BUDGET_S", 1140))
    skipped: list = []
    sect_s: dict = {}
    cands: list = []

    def over_budget(margin: float = 0.0) -> bool:
        return budget_s > 0 and time.perf_counter() - t_start + margin >= budget_s

    def emit() -> None:
        pool = []
        for label, p50, rkey in cands:
            rec = 1.0 if rkey is None else extras.get(rkey)
            if rec is not None and float(rec) >= 0.99:
                pool.append((p50, float(rec), label))
        if not pool:
            return  # nothing measured yet — keep whatever was last printed
        headline, head_recall, head_tier = min(pool, key=lambda c: c[0])
        extras["headline_tier"] = head_tier
        extras["recall_vs_exact"] = round(head_recall, 6)
        extras["elapsed_s"] = round(time.perf_counter() - t_start, 1)
        extras["skipped_sections"] = list(skipped)
        extras["section_seconds"] = {k: round(v, 1) for k, v in
                                     sect_s.items()}
        print(json.dumps({
            "metric": "p50_query_latency_1M_docs_k10",
            "value": round(headline, 4),
            "unit": "ms",
            "vs_baseline": round(BASELINE_QUERY_MS / headline, 2),
            "extras": extras,
        }), flush=True)

    def _on_signal(signum: int, frame: object) -> None:
        skipped.append(f"interrupted_by_signal_{signum}")
        emit()
        os._exit(124)

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGALRM, _on_signal)
    if budget_s > 0:
        signal.alarm(int(budget_s + 120))

    def p50_ms(fn) -> float:
        jax.block_until_ready(fn())
        ts = []
        for _ in range(REPS):
            t = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t)
        return statistics.median(ts) * 1e3

    def section(name: str, margin: float = 60.0) -> bool:
        if name not in SECTIONS:
            return False
        if over_budget(margin):
            skipped.append(name)
            return False
        return True

    k_emb, k_sig, k_q = jax.random.split(jax.random.PRNGKey(0), 3)
    emb = np.asarray(jax.random.normal(k_emb, (N_DOCS, DIM), jnp.float32))
    sig = jax.random.gamma(k_sig, 2.0, (N_DOCS, 7), dtype=jnp.float32)
    queries = np.asarray(jax.random.normal(k_q, (N_QUERIES, DIM),
                                           jnp.float32))
    doc_ids = [str(i) for i in range(N_DOCS)]

    # ---- build: robust-stat fit + DEWI scoring + index build -------------
    t0 = time.perf_counter()
    dewi = DewiScorer().fit_and_score(sig)
    pay = np.asarray(jnp.concatenate([dewi[:, None], sig], axis=1))

    def tier(**kw) -> DewiIndex:
        index = DewiIndex(dim=DIM, rerank_eta=ETA, entropy_pref=EP, **kw)
        index.add_batch(doc_ids, emb, pay)
        index.build()
        return index

    exact = tier(backend="exact")
    jax.block_until_ready(exact._backend.store.device_arrays()[0])
    build_s = time.perf_counter() - t0
    extras["index_score_build_s"] = round(build_s, 2)
    extras["index_docs_per_sec"] = round(N_DOCS / build_s, 1)
    extras["build_vs_baseline"] = round(BASELINE_BUILD_S / build_s, 1)
    sect_s["build"] = build_s

    def search(index, q, k=K):
        return index.search_batch(q, k=k, eta=ETA, entropy_pref=EP)

    def q1(index) -> float:
        return p50_ms(lambda: search(index, queries[:1]))

    truth = {}

    def recall_of(index, k: int) -> float:
        if k not in truth:
            truth[k] = np.concatenate([
                np.asarray(reference_topk(emb, pay, queries[a:a + 250], k=k,
                                          eta=ETA, entropy_pref=EP)[1])
                for a in range(0, N_QUERIES, 250)
            ])
        got = np.concatenate([
            np.asarray(search(index, queries[a:a + 250], k)[1])
            for a in range(0, N_QUERIES, 250)
        ])
        return float(recall_matrix(got, truth[k]))

    # ---- core: exact tiers --------------------------------------------------
    t_sec = time.perf_counter()
    extras["f32_p50_ms"] = round(q1(exact), 4)
    cands.append(("f32 exact", extras["f32_p50_ms"], None))
    emit()
    bf16 = tier(backend="exact", dtype=jnp.bfloat16)
    extras["bf16_store_p50_ms"] = round(q1(bf16), 4)
    cands.append(("bf16-store exact", extras["bf16_store_p50_ms"],
                  "bf16_recall_vs_f32_at_k10"))
    if not over_budget(margin=30.0):
        jax.block_until_ready(search(exact, queries))
        t = time.perf_counter()
        jax.block_until_ready(search(exact, queries))
        batch_s = time.perf_counter() - t
        extras["batched_qps"] = round(N_QUERIES / batch_s, 1)
        extras["batched_ms_per_query"] = round(batch_s / N_QUERIES * 1e3, 4)
    sect_s["core"] = time.perf_counter() - t_sec
    emit()

    tiers = {"bf16": bf16}
    # ---- int8 / int4 quantized tiers ----------------------------------------
    for name, kw in (("int8", dict(backend="quantized")),
                     ("int8_s8", dict(backend="quantized", int8_queries=True)),
                     ("int4", dict(backend="int4"))):
        sec = "int4" if name == "int4" else "int8"
        if not section(sec):
            continue
        t_sec = time.perf_counter()
        tiers[name] = tier(**kw)
        extras[f"{name}_p50_ms"] = round(q1(tiers[name]), 4)
        cands.append((name, extras[f"{name}_p50_ms"],
                      f"{name}_recall_vs_f32_at_k10"))
        sect_s[name] = time.perf_counter() - t_sec
        emit()

    # ---- recall vs the f32 reference: full query set, k=10 and k=100 -------
    if section("recall", margin=0.0):
        t_sec = time.perf_counter()
        extras["f32_recall_vs_reference_at_k10"] = round(
            recall_of(exact, K), 6)
        for name, index in tiers.items():
            for k in (K, 100):
                extras[f"{name}_recall_vs_f32_at_k{k}"] = round(
                    recall_of(index, k), 6)
        extras["recall_queries"] = N_QUERIES
        sect_s["recall"] = time.perf_counter() - t_sec
        emit()
    del tiers, bf16

    # ---- IVF tier on a clustered corpus (IVF's realistic case) --------------
    if section("ivf", margin=90.0):
        t_sec = time.perf_counter()
        from dewi.index.ivf import IVFIndex

        nc = 512
        kc1, kc2, kc3, kq = jax.random.split(jax.random.PRNGKey(7), 4)
        centers = jax.random.normal(kc1, (nc, DIM), jnp.float32) * 3.0
        labels = jax.random.randint(kc2, (N_DOCS,), 0, nc)
        cemb = np.asarray(centers[labels] + jax.random.normal(
            kc3, (N_DOCS, DIM), jnp.float32))
        cq = np.asarray(centers[jax.random.randint(kq, (N_QUERIES,), 0, nc)]
                        + jax.random.normal(kq, (N_QUERIES, DIM), jnp.float32))
        ivf = IVFIndex(dim=DIM, nlist=1024, nprobe=32)
        ivf.add_batch(doc_ids, cemb, pay)
        t0 = time.perf_counter()
        ivf.build()
        extras["ivf_build_s"] = round(time.perf_counter() - t0, 2)
        extras["ivf_p50_ms"] = round(p50_ms(lambda: ivf.search_batch(
            cq[:1], k=K, eta=ETA, entropy_pref=EP)), 4)
        got = np.concatenate([
            np.asarray(ivf.search_batch(cq[a:a + 250], k=K, eta=ETA,
                                        entropy_pref=EP)[1])
            for a in range(0, N_QUERIES, 250)
        ])
        want = np.concatenate([
            np.asarray(reference_topk(cemb, pay, cq[a:a + 250], k=K,
                                      eta=ETA, entropy_pref=EP)[1])
            for a in range(0, N_QUERIES, 250)
        ])
        extras["ivf_recall_at_k10_clustered"] = round(
            float(recall_matrix(got, want)), 4)
        del ivf, cemb
        sect_s["ivf"] = time.perf_counter() - t_sec
        emit()

    # ---- signal backbones (small preset docs/sec) + redundancy --------------
    if section("signals", margin=90.0):
        t_sec = time.perf_counter()
        from dewi.signals import TextEntropyEstimator
        from dewi.signals.image_entropy import ImageEntropyEstimator
        from dewi.signals.redundancy import max_offdiag_similarity

        est = TextEntropyEstimator(model_name="small", batch_size=512)
        S, bs = est.superbatch, est.batch_size
        ids3 = jnp.full((S, bs, 256), 65, jnp.int32)
        mask3 = jnp.ones((S, bs, 256), jnp.float32)
        ms = p50_ms(lambda: est._score_super(est.params, ids3, mask3))
        extras["signals_text_docs_per_sec"] = round(S * bs / ms * 1e3, 1)

        ie = ImageEntropyEstimator(model_name="small", batch_size=64)
        img4 = jnp.zeros((ie.superbatch, 64, 224, 224, 3), jnp.float32)
        rngs = jax.random.split(jax.random.PRNGKey(0), ie.superbatch)
        ms = p50_ms(lambda: ie._stats_super(ie.params, img4, rngs))
        extras["signals_image_docs_per_sec"] = round(
            ie.superbatch * 64 / ms * 1e3, 1)

        emb_d = exact._backend.store.device_arrays()[0]
        t0 = time.perf_counter()
        jax.block_until_ready(max_offdiag_similarity(emb_d, block=4096))
        extras["signals_redundancy_s"] = round(time.perf_counter() - t0, 2)
        sect_s["signals"] = time.perf_counter() - t_sec

    signal.alarm(0)
    emit()


if __name__ == "__main__":
    sys.exit(main())
