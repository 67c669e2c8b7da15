#!/usr/bin/env python
"""Run DEWI's main path once on one GPU and check what comes out.

    python chip_smoke.py                 # the default phases on one card
    python chip_smoke.py --four-cards    # only the sharded paths, 4 cards
    python chip_smoke.py --phases index,kernels   # a subset of the phases

Phases (all in this one process; one JAX process per card):

1. device   — the first JAX device must be a GPU; never falls back.
2. process  — ``DewiPipeline.process_corpus`` with the default full-width
              backbones (gpt2 LM, vit-mae-base, clip-vit-base-patch32) on
              seeded text+image documents, then ``build_index_corpus`` and
              ``encode_query`` searches; the LM surprisal and MAE loss are
              compared with the same forwards in float32 at HIGHEST.
3. index    — every index tier at 1M x 256 through ``DewiIndex.add_batch``
              + ``build`` + ``search_batch``: Q=1 / Q=32 latency and
              recall@10 against a float32 ground truth at HIGHEST precision.
4. serve    — ``SearchServer`` over the 1M int8 index on localhost, 64
              concurrent ``/search`` requests from threads, each answer
              compared with ``search_batch``.
5. kernels  — the fused stage-1 kernel against a plain numpy reference at
              1M x 256, Q in {1, 8, 32}, and the kernel and XLA's two-pass
              path timed end to end through ``quantized_search``.

``--four-cards`` runs only the sharded paths over a ``(data=4)`` mesh:
``search`` (sharded exact, int8, int4 and IVF search at 4M x 256 against
one device) and ``signals`` (data-parallel ``process_corpus`` at the
default full-width presets against one device).

Times are host-clock medians of warm calls ending in ``block_until_ready``.
The last line of standard output is the contract line
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed.  Data and weights come from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List

import numpy as np

K, ETA, EP = 10, 0.25, 0.1      # reference protocol (profile_index.py:241-254)
RECALL_GATE = 0.99
INTERPRET = False               # kernels in interpret mode (CPU rehearsals only)


def log(*parts: Any) -> None:
    print(*parts, flush=True)


def timed_ms(fn: Callable[[], Any], reps: int = 30) -> float:
    """Warm median of ``fn()`` in ms, each call ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t)
    return statistics.median(ts) * 1e3


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if not smi:
        return "nvidia-smi not found"
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or out.stderr.strip()


def same_topk(ids_a: np.ndarray, ids_b: np.ndarray, scores_b: np.ndarray,
              score_of: Callable[[int, int], float], tol: float) -> bool:
    """Row-wise equal top-k ids, ties aside: a position may hold another id
    only if the two ids' reference scores agree within ``tol``."""
    for r in range(ids_a.shape[0]):
        for j in range(ids_a.shape[1]):
            a, b = int(ids_a[r, j]), int(ids_b[r, j])
            if a != b and abs(score_of(r, a) - score_of(r, b)) > tol:
                return False
    return True


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

_WORDS = None


def make_texts(rng: np.random.Generator, n: int, lo: int = 512,
               hi: int = 4096) -> List[str]:
    """Seeded pseudo-English documents of ``lo``..``hi`` bytes."""
    global _WORDS
    if _WORDS is None:
        letters = np.array(list("etaoinshrdlucmfwypvbgkjqxz"))
        p = 1.0 / np.arange(1, 27)
        p /= p.sum()
        wrng = np.random.default_rng(1234)
        _WORDS = ["".join(wrng.choice(letters, size=wrng.integers(2, 9), p=p))
                  for _ in range(5000)]
    zipf = 1.0 / np.arange(1, len(_WORDS) + 1)
    zipf /= zipf.sum()
    out = []
    for size in rng.integers(lo, hi + 1, n):
        words = rng.choice(len(_WORDS), size=size // 3, p=zipf)
        text = " ".join(_WORDS[w] for w in words)
        out.append(text[:size])
    return out


def make_images(rng: np.random.Generator, n: int, size: int = 224
                ) -> np.ndarray:
    """Seeded RGB images: smooth gradients plus texture of varying strength."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        a = rng.uniform(0, 255, 3)
        b = rng.uniform(-120, 120, (2, 3))
        noise = rng.normal(0, rng.uniform(2, 60), (size, size, 3))
        img = a + xx[..., None] * b[0] + yy[..., None] * b[1] + noise
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def random_corpus(seed: int, n: int, d: int, n_queries: int) -> Dict[str, Any]:
    """Gaussian corpus (the reference's random protocol) with DEWI payloads."""
    import jax
    import jax.numpy as jnp

    k_e, k_q, k_p = jax.random.split(jax.random.key(seed), 3)
    emb = np.asarray(jax.random.normal(k_e, (n, d), jnp.float32))
    q = np.asarray(jax.random.normal(k_q, (n_queries, d), jnp.float32))
    return {"emb": emb, "queries": q, "pay": _payloads(k_p, n)}


def clustered_corpus(seed: int, n: int, d: int, n_queries: int,
                     modes: int = 512) -> Dict[str, Any]:
    """Zipf mixture of ``modes`` Gaussian clusters, queries drawn near the
    cluster centres (scripts/profile_ivf_1m.py's protocol)."""
    import jax
    import jax.numpy as jnp

    kc, kl, kn, kq1, kq2, k_p = jax.random.split(jax.random.key(seed), 6)
    centers = jax.random.normal(kc, (modes, d), jnp.float32) * 3.0
    w = 1.0 / (jnp.arange(modes) + 1.0)
    labels = jax.random.categorical(kl, jnp.log(w / w.sum()), shape=(n,))
    emb = np.asarray(centers[labels]
                     + jax.random.normal(kn, (n, d), jnp.float32))
    q = np.asarray(centers[jax.random.randint(kq1, (n_queries,), 0, modes)]
                   + jax.random.normal(kq2, (n_queries, d), jnp.float32))
    return {"emb": emb, "queries": q, "pay": _payloads(k_p, n)}


def _payloads(key: Any, n: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from dewi.scorer import DewiScorer

    sig = jax.random.gamma(key, 2.0, (n, 7), jnp.float32)
    dewi = DewiScorer().fit_and_score(sig)
    return np.asarray(jnp.concatenate([dewi[:, None], sig], axis=1))


def ground_truth(data: Dict[str, Any], k: int = K) -> Dict[str, np.ndarray]:
    """Float32 top-k at HIGHEST precision (metrics.reference_topk), plus the
    reference score of every (query, doc) pair the checks ask about."""
    from dewi.metrics import reference_topk

    scores, idx = reference_topk(data["emb"], data["pay"], data["queries"],
                                 k=k, eta=ETA, entropy_pref=EP)
    return {"ids": np.asarray(idx), "scores": np.asarray(scores)}


def reference_score(data: Dict[str, Any], qi: int, doc: int) -> float:
    e = data["emb"][doc].astype(np.float64)
    q = data["queries"][qi].astype(np.float64)
    cos = float(e @ q / (np.linalg.norm(e) * np.linalg.norm(q)))
    p = data["pay"][doc]
    return (1 - ETA) * cos + ETA * float(p[0]) + EP * 0.5 * float(p[1] + p[3])


# ---------------------------------------------------------------------------
# Phase 2: process at full width
# ---------------------------------------------------------------------------


def phase_process(seed: int, n_docs: int = 2048, config: Any = None) -> None:
    import jax
    import jax.numpy as jnp

    from dewi.config import DewiConfig
    from dewi.corpus import Corpus
    from dewi.pipelines import DewiPipeline
    from dewi.signals.image_entropy import normalize_images

    cfg = config or DewiConfig()
    log(f"process: lm={cfg.text.model} mae={cfg.image.model} "
        f"clip={cfg.cross_modal.model} docs={n_docs}")
    rng = np.random.default_rng(seed)
    texts = make_texts(rng, n_docs)
    images = make_images(rng, n_docs, cfg.image.image_size)
    ids = [f"doc{i}" for i in range(n_docs)]
    over = sum(len(t.encode()) >= cfg.text.max_length for t in texts)
    log(f"process: {over}/{n_docs} texts exceed max_length="
        f"{cfg.text.max_length} (window path)")

    pipe = DewiPipeline(cfg)
    t0 = time.perf_counter()
    corpus = pipe.process_corpus(Corpus(ids=ids, texts=list(texts),
                                        images=images))
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # progress=True: per-stage rates on stderr (where the warm time goes).
    corpus = pipe.process_corpus(Corpus(ids=ids, texts=list(texts),
                                        images=images), progress=True)
    warm_s = time.perf_counter() - t0
    log(f"process: cold {cold_s:.2f} s, warm {warm_s:.2f} s = "
        f"{n_docs / warm_s:.2f} docs/s warm")
    if not np.all(np.isfinite(corpus.signals)):
        raise AssertionError("non-finite signals")
    dewi = np.asarray(corpus.dewi)
    if not (np.all(np.isfinite(dewi)) and dewi.min() >= 0.0
            and dewi.max() <= 1.0):
        raise AssertionError(f"DEWI outside [0,1]: {dewi.min()}..{dewi.max()}")
    log(f"process: signals finite, DEWI in [{dewi.min():.4f}, "
        f"{dewi.max():.4f}]")

    index = pipe.build_index_corpus(corpus)
    for text in ("the quick brown fox", texts[0][:80], "entropy"):
        res = index.search(pipe.encode_query(text), k=K)
        if len(res) != K or not all(np.isfinite(s) for _, s, _ in res):
            raise AssertionError(f"bad search result for {text!r}")
    log(f"process: index of {len(index)} docs answered 3 encode_query "
        "searches")

    # Precision: the backbones compute in bf16.  The same forwards with a
    # float32 compute dtype at HIGHEST matmul precision (same parameters)
    # bound the bf16 error on a 64-document slice: per-document means may
    # differ by 2e-2 relative.
    te, ie = pipe.text_entropy, pipe.image_entropy
    tok_ids, mask = te.tokenizer.encode_batch(texts[:64], cfg.text.max_length,
                                              pad_to=cfg.text.max_length)

    def f32(model: Any) -> Any:
        return dataclasses.replace(
            model, cfg=dataclasses.replace(model.cfg, dtype="float32"))

    def lm_surprisal(model: Any) -> Any:
        from dewi.models.lm import token_nll

        @jax.jit
        def fn(params: Any, ids_: Any, mask_: Any) -> Any:
            nll, valid = token_nll(model.apply(params, ids_, mask_), ids_,
                                   mask_)
            return jnp.sum(nll * valid, 1) / jnp.maximum(jnp.sum(valid, 1), 1)
        return fn

    def mae_loss(model: Any) -> Any:
        return jax.jit(lambda params, imgs: model.apply(
            params, normalize_images(imgs), jax.random.key(seed)))

    imgs64 = jnp.asarray(images[:64])
    if imgs64.shape[1] != ie.cfg.image_size:
        imgs64 = jax.image.resize(
            imgs64.astype(jnp.float32),
            (64, ie.cfg.image_size, ie.cfg.image_size, 3), "bilinear")
    a_lm = np.asarray(lm_surprisal(te.model)(te.params, tok_ids, mask))
    a_mae = np.asarray(mae_loss(ie.model)(ie.params, imgs64))
    with jax.default_matmul_precision("highest"):
        b_lm = np.asarray(lm_surprisal(f32(te.model))(te.params, tok_ids,
                                                      mask))
        b_mae = np.asarray(mae_loss(f32(ie.model))(ie.params, imgs64))
    for name, a, b in (("LM token surprisal", a_lm, b_lm),
                       ("MAE reconstruction loss", a_mae, b_mae)):
        diff = np.abs(a - b)
        rel = float(np.max(diff / np.maximum(np.abs(b), 1e-6)))
        log(f"precision: {name}, bf16 compute vs float32 at HIGHEST: max abs "
            f"{float(diff.max()):.3e}, max rel {rel:.3e} (tolerance rel 2e-2)")
        if not (np.all(np.isfinite(a)) and rel <= 2e-2):
            raise AssertionError(f"{name} differs beyond tolerance")


# ---------------------------------------------------------------------------
# Phase 3: every index tier at 1M x 256
# ---------------------------------------------------------------------------


TIERS = (
    ("exact f32", dict(backend="exact")),
    ("exact bf16", dict(backend="exact", bf16=True)),
    ("int8", dict(backend="quantized")),
    ("int8 int8_queries", dict(backend="quantized", int8_queries=True)),
    ("int4", dict(backend="int4")),
    ("ivf", dict(backend="ivf")),
)


def build_tier(data: Dict[str, Any], spec: Dict[str, Any]) -> Any:
    import jax.numpy as jnp

    from dewi.index import DewiIndex

    kw = dict(spec)
    if kw.pop("bf16", False):
        kw["dtype"] = jnp.bfloat16
    index = DewiIndex(dim=data["emb"].shape[1], rerank_eta=ETA,
                      entropy_pref=EP, **kw)
    index.add_batch([str(i) for i in range(len(data["emb"]))], data["emb"],
                    data["pay"])
    index.build()
    return index


def tier_search(index: Any, q: np.ndarray, k: int = K) -> Any:
    return index.search_batch(q, k=k, eta=ETA, entropy_pref=EP)


def phase_index(seed: int, n: int = 1 << 20, d: int = 256,
                n_queries: int = 1000) -> Dict[str, Any]:
    """Returns the built int8 index and its data for the serve phase."""
    rand = random_corpus(seed, n, d, n_queries)
    clus = clustered_corpus(seed + 1, n, d, n_queries)
    gts = {"random": ground_truth(rand), "clustered": ground_truth(clus)}
    keep: Dict[str, Any] = {}
    for name, spec in TIERS:
        corpus_name = "clustered" if spec["backend"] == "ivf" else "random"
        data = rand if corpus_name == "random" else clus
        gt = gts[corpus_name]
        t0 = time.perf_counter()
        index = build_tier(data, spec)
        build_s = time.perf_counter() - t0
        lat = {}
        for nq in (1, 32):
            q = data["queries"][:nq]
            lat[nq] = timed_ms(lambda: tier_search(index, q))
        ids = np.concatenate([
            np.asarray(tier_search(index, data["queries"][a:a + 250])[1])
            for a in range(0, n_queries, 250)
        ])
        from dewi.metrics import recall_matrix

        recall = recall_matrix(ids, gt["ids"])
        log(f"tier {name:18s} ({corpus_name} {n}x{d}): build {build_s:.2f} s, "
            f"Q=1 {lat[1]:.4f} ms, Q=32 {lat[32]:.4f} ms, "
            f"recall@{K} {recall:.4f}")
        if recall < RECALL_GATE:
            raise AssertionError(f"{name}: recall {recall} < {RECALL_GATE}")
        if name == "exact f32" and not same_topk(
            ids, gt["ids"], gt["scores"],
            lambda r, doc: reference_score(data, r, doc), tol=1e-6,
        ):
            raise AssertionError("exact f32 ids differ from the ground truth")
        if name == "int8":
            keep = {"index": index, "data": data}
        else:
            del index
    return keep


# ---------------------------------------------------------------------------
# Phase 4: served search
# ---------------------------------------------------------------------------


def phase_serve(index: Any, data: Dict[str, Any], n_requests: int = 64
                ) -> None:
    import http.client

    from dewi.serve import SearchServer

    server = SearchServer(index, host="127.0.0.1", port=0)
    server.start()
    try:
        queries = data["queries"][:n_requests]
        answers: List[Any] = [None] * n_requests
        errors: List[str] = []
        barrier = threading.Barrier(n_requests)

        def client(i: int) -> None:
            try:
                body = json.dumps({"vector": queries[i].tolist(), "k": K,
                                   "eta": ETA, "entropy_pref": EP})
                barrier.wait(timeout=60)
                conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                                  timeout=600)
                conn.request("POST", "/search", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read())
                conn.close()
                if resp.status != 200:
                    errors.append(f"{i}: HTTP {resp.status} {payload}")
                answers[i] = payload
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"serve errors: {errors[:3]}")
        doc_ids = index.doc_ids
        mismatches = 0
        for i in range(n_requests):
            s, r = tier_search(index, queries[i:i + 1])
            want_ids = [doc_ids[int(j)] for j in np.asarray(r)[0]]
            got_ids = answers[i]["ids"]
            want_s = np.asarray(s)[0]
            got_s = np.asarray(answers[i]["scores"], np.float32)
            if got_ids != want_ids and not np.allclose(got_s, want_s,
                                                       atol=1e-5):
                mismatches += 1
        stats = server.health()
        log(f"serve: {n_requests} concurrent /search in {wall:.3f} s, "
            f"{stats.get('dispatches')} dispatches, {mismatches} answers "
            "differ from search_batch")
        if mismatches:
            raise AssertionError(f"{mismatches} served answers differ")
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# Phase 5: the fused stage-1 kernel against XLA
# ---------------------------------------------------------------------------


def phase_kernels(seed: int, n: int = 1 << 20, d: int = 256) -> None:
    import jax
    import jax.numpy as jnp

    from dewi.ops.pallas_search import pallas_bmax
    from dewi.ops.quantized import (
        BLOCKMAX_SUB,
        quantize_rows,
        quantize_rows_int4,
        quantized_search,
        unpack_int4,
    )

    data = random_corpus(seed + 2, n, d, 32)
    x = jnp.asarray(data["emb"])
    xn = x / jnp.linalg.norm(x, axis=1, keepdims=True)
    e8, s8 = quantize_rows(xn)
    p4, s4 = quantize_rows_int4(xn)
    u4 = unpack_int4(p4)
    sqn = jnp.sum(xn * xn, 1)
    pay = jnp.asarray(data["pay"])
    mult = jax.random.uniform(jax.random.key(seed), (n,))
    add = jax.random.uniform(jax.random.key(seed + 1), (n,)) * 0.1
    dims = (((1,), (1,)), ((), ()))

    def xla_bmax(emb: Any, q: Any, qs: Any, mode: str) -> Any:
        """XLA's two-pass stage 1 (the path taken where the kernel is not)."""
        if mode == "bf16":
            acc = jax.lax.dot_general(q.astype(jnp.bfloat16),
                                      emb.astype(jnp.bfloat16), dims,
                                      preferred_element_type=jnp.float32)
        else:
            acc = jax.lax.dot_general(
                q, emb, dims, preferred_element_type=jnp.int32
            ).astype(jnp.float32) * qs[:, None]
        return jnp.max((acc * mult + add).reshape(q.shape[0], -1,
                                                  BLOCKMAX_SUB), -1)

    mult_h, add_h = np.asarray(mult), np.asarray(add)

    def ref_bmax(emb: Any, q: Any, qs: Any, mode: str) -> np.ndarray:
        """Plain reference on the host: numpy f32 over the same operands
        (the bf16 query rounded first), out of reach of XLA's rewrites."""
        if mode == "bf16":
            q = q.astype(jnp.bfloat16)
        acc = np.asarray(q, np.float32) @ emb.T
        if mode != "bf16":
            acc = acc * np.asarray(qs)[:, None]
        return np.max((acc * mult_h + add_h).reshape(q.shape[0], -1,
                                                     BLOCKMAX_SUB), -1)

    xla_bmax_j = jax.jit(xla_bmax, static_argnames="mode")
    e8_h, u4_h = np.asarray(e8, np.float32), np.asarray(u4, np.float32)
    # (mode, corpus the kernel reads, corpus the others read, relative
    # tolerance, what the kernel computes).  The bf16 products are exact in
    # f32, so only the summation order differs from the reference.
    cases = (
        ("bf16", e8, e8, e8_h, 1e-5,
         "int8 corpus x bf16 query, f32 accumulation"),
        ("s8", e8, e8, e8_h, 1e-6, "int8 x int8, int32 accumulation"),
        ("s4", p4, u4, u4_h, 1e-6, "packed int4 x int8, int32 accumulation"),
    )
    for nq in (1, 8, 32):
        q = jnp.asarray(data["queries"][:nq])
        qn = q / jnp.linalg.norm(q, axis=1, keepdims=True)
        qi, qs = quantize_rows(qn)
        for mode, ek, ex, eh, tol, prec in cases:
            qk = qn if mode == "bf16" else qi
            qsk = jnp.ones((nq,)) if mode == "bf16" else qs
            want = ref_bmax(eh, qk, qsk, mode)
            scale = float(np.max(np.abs(want)))
            got = np.asarray(pallas_bmax(ek, mult, add, qk, qsk, mode=mode,
                                         interpret=INTERPRET))
            err = float(np.max(np.abs(got - want))) / scale
            xerr = float(np.max(np.abs(
                np.asarray(xla_bmax_j(ex, qk, qsk, mode=mode)) - want))) / scale
            log(f"kernel {mode} Q={nq}: max rel diff {err:.3e} vs the numpy "
                f"f32 reference (tolerance {tol:g}; {prec}); XLA "
                f"two-pass {xerr:.3e}")
            if not err <= tol:
                raise AssertionError(f"kernel {mode} Q={nq} parity {err}")

    n_valid = jnp.int32(n)
    eta, ep = jnp.float32(ETA), jnp.float32(EP)
    tiers = (
        ("int8 (bf16 queries)", e8, s8, dict(), dict()),
        ("int8 int8_queries", e8, s8, dict(int8_queries=True), dict()),
        ("int4", p4, s4, dict(int8_queries=True, int4_packed=True),
         dict(int8_queries=True, int4_values=True)),
    )
    for name, emb_k, sc, kw_k, kw_x in tiers:
        emb_x = u4 if "int4_values" in kw_x else emb_k
        kw_x = kw_x or kw_k
        for nq in (1, 32):
            q = jnp.asarray(data["queries"][:nq])
            m = (4 if "int4" in name else 1) * K * 8

            def run(emb_: Any, kernel: bool, kw: Dict[str, Any]) -> Any:
                return quantized_search(
                    emb_, sc, xn, sqn, pay, q, n_valid, eta, ep, k=K, m=m,
                    blockmax_select=True, bmax_kernel=kernel,
                    interpret=INTERPRET, **kw)

            t_k = timed_ms(lambda: run(emb_k, True, kw_k), reps=50)
            t_x = timed_ms(lambda: run(emb_x, False, kw_x), reps=50)
            _, ik = run(emb_k, True, kw_k)
            _, ix = run(emb_x, False, kw_x)
            agree = float(np.mean(np.asarray(ik) == np.asarray(ix)))
            log(f"quantized_search {name} Q={nq}: kernel {t_k:.4f} ms, "
                f"XLA two-pass {t_x:.4f} ms, ids agree {agree:.4f}")
            # Both paths select blocks from the same stage-1 values, so
            # they must return the same ids.
            if agree < 1.0:
                raise AssertionError(f"{name} Q={nq}: kernel and XLA ids "
                                     f"agree {agree}")

    for nq in (1, 32):
        s = jax.random.normal(jax.random.key(seed + 3), (nq, n))
        fa = jax.jit(lambda s: jax.lax.approx_max_k(
            s, 80, recall_target=0.95, aggregate_to_topk=False)[1])
        ft = jax.jit(lambda s: jax.lax.top_k(s, 80)[1])
        log(f"select Q={nq} over {n}: approx_max_k {timed_ms(lambda: fa(s)):.4f}"
            f" ms, top_k {timed_ms(lambda: ft(s)):.4f} ms")


# ---------------------------------------------------------------------------
# Four cards: the sharded paths against one device
# ---------------------------------------------------------------------------


def phase_four_cards_search(seed: int, n: int = 4 << 20, d: int = 256,
                            n_queries: int = 1000) -> None:
    import jax

    from dewi.index.ivf import IVFIndex
    from dewi.index.store import DocStore
    from dewi.metrics import recall_matrix
    from dewi.parallel import (
        ShardedExactSearcher,
        ShardedIVFSearcher,
        ShardedQuantizedSearcher,
        make_mesh,
    )

    mesh = make_mesh()
    log(f"four-cards: mesh {dict(mesh.shape)} over {len(jax.devices())} "
        f"devices, corpus {n}x{d} f32")

    def store_of(data: Dict[str, Any]) -> Any:
        st = DocStore(dim=d)
        st.add_batch([str(i) for i in range(n)], data["emb"], data["pay"])
        return st

    def run_sharded(searcher: Any, data: Dict[str, Any]) -> np.ndarray:
        return np.concatenate([
            np.asarray(searcher.search_batch(data["queries"][a:a + 250],
                                             eta=ETA, entropy_pref=EP)[1])
            for a in range(0, n_queries, 250)
        ])

    rand = random_corpus(seed, n, d, n_queries)
    gt = ground_truth(rand)   # single device, HIGHEST precision
    ex = ShardedExactSearcher(store_of(rand), mesh, k=K)
    ids = run_sharded(ex, rand)
    ok = same_topk(ids, gt["ids"], gt["scores"],
                   lambda r, doc: reference_score(rand, r, doc), tol=1e-6)
    log(f"four-cards: sharded exact vs single-device ids equal (ties aside): "
        f"{ok}")
    if not ok:
        raise AssertionError("sharded exact differs from single device")
    for name, kw in (("int8", {}), ("int4", dict(int4_storage=True))):
        qs = ShardedQuantizedSearcher(store_of(rand), mesh, k=K, **kw)
        rec = recall_matrix(run_sharded(qs, rand), gt["ids"])
        log(f"four-cards: sharded quantized {name} recall@{K} {rec:.4f}")
        if rec < RECALL_GATE:
            raise AssertionError(f"sharded {name} recall {rec}")
        del qs

    clus = clustered_corpus(seed + 1, n, d, n_queries)
    gtc = ground_truth(clus)
    ivf = IVFIndex(dim=d)
    ivf.add_batch([str(i) for i in range(n)], clus["emb"], clus["pay"])
    ivf.build()
    single = np.concatenate([
        np.asarray(ivf.search_batch(clus["queries"][a:a + 250], k=K, eta=ETA,
                                    entropy_pref=EP)[1])
        for a in range(0, n_queries, 250)
    ])
    sh = ShardedIVFSearcher(ivf, mesh, k=K)
    rec_s = recall_matrix(run_sharded(sh, clus), gtc["ids"])
    rec_1 = recall_matrix(single, gtc["ids"])
    log(f"four-cards: IVF recall@{K} sharded {rec_s:.4f}, single-device "
        f"{rec_1:.4f} (clustered corpus)")
    if rec_s < RECALL_GATE:
        raise AssertionError(f"sharded IVF recall {rec_s}")


def phase_four_cards_signals(seed: int, n_docs: int = 256,
                             config: Any = None) -> None:
    """Data-parallel ``process_corpus`` at the default full-width presets
    (gpt2, vit-mae-base, clip-vit-base-patch32; 224-px images, texts on the
    window path) over the ``(data=4)`` mesh, against one device, at the
    tolerance of tests/test_parallel_signals.py.

    Both runs compute in float32 at HIGHEST precision.  In bf16 the two
    runs' GEMMs have different shapes (each card runs a quarter of every
    batch) and round differently, and no single-device run can stand in
    for the per-card shape: the MAE draws its patch masks per batch, so a
    smaller batch is a different computation."""
    import jax

    from dewi.config import DewiConfig
    from dewi.corpus import Corpus
    from dewi.models import registry
    from dewi.parallel import make_mesh
    from dewi.pipelines import DewiPipeline

    import dewi.io.device_images as di

    mesh = make_mesh()
    cfg = config or DewiConfig()
    log(f"four-cards: lm={cfg.text.model} mae={cfg.image.model} "
        f"clip={cfg.cross_modal.model}, {n_docs} docs, float32 at HIGHEST")
    rng = np.random.default_rng(seed)
    texts = make_texts(rng, n_docs)
    imgs = make_images(rng, n_docs, cfg.image.image_size)

    def run(m: Any = None) -> Any:
        t0 = time.perf_counter()
        out = DewiPipeline(cfg, mesh=m).process_corpus(Corpus(
            ids=[f"d{i}" for i in range(n_docs)], texts=list(texts),
            images=imgs.copy()))
        log(f"four-cards: process_corpus ({'mesh' if m else 'one device'}) "
            f"{time.perf_counter() - t0:.2f} s")
        return out

    presets = (registry.LM_PRESETS[cfg.text.model],
               registry.MAE_PRESETS[cfg.image.model],
               registry.CLIP_PRESETS[cfg.cross_modal.model])
    # Every run decodes on the host, as in the CPU test: the mesh run keeps
    # images off the device, and the on-device resize is another kernel.
    saved = di.MAX_BYTES
    di.MAX_BYTES = 0
    for p in presets:
        p["dtype"] = "float32"
    try:
        with jax.default_matmul_precision("highest"):
            c0, c1 = run(), run(mesh)
    finally:
        di.MAX_BYTES = saved
        for p in presets:
            p.pop("dtype", None)
    sig_err = float(np.max(np.abs(c1.signals - c0.signals)
                           - 1e-4 * np.abs(c0.signals)))
    dewi_err = float(np.max(np.abs(c1.dewi - c0.dewi)
                            - 1e-3 * np.abs(c0.dewi)))
    log(f"four-cards: data-parallel signals vs one device: max |diff| - "
        f"1e-4|ref| = {sig_err:.3e} (tolerance 1e-5); DEWI max |diff| - "
        f"1e-3|ref| = {dewi_err:.3e} (tolerance 1e-3)")
    if not np.all(np.isfinite(c1.signals)):
        raise AssertionError("non-finite data-parallel signals")
    np.testing.assert_allclose(c1.signals, c0.signals, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c1.dewi, c0.dewi, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths over 4 cards")
    ap.add_argument("--phases", default=None,
                    help="comma list of phases to run (default: process,"
                         "index,serve,kernels; with --four-cards: "
                         "search,signals)")
    args = ap.parse_args()

    try:
        import dewi  # noqa: F401 — the checkout must be importable
        import jax
    except ImportError as e:
        log(f"FAIL: cannot import the program ({e})")
        return 2
    if os.environ.get("DEWI_TEST_MODE"):
        log("FAIL: DEWI_TEST_MODE is set (it replaces IO with mock data)")
        return 2
    devices = jax.devices()
    dev = devices[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(devices)}")
    if dev.platform != "gpu":
        log("FAIL: no GPU found; this script never falls back to the CPU")
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        log(f"FAIL: need {want} GPUs, found {len(devices)}")
        return 2
    log(f"card: {card_line()}")

    from dewi.utils.compile_cache import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")

    failed: List[str] = []

    def run(name: str, fn: Callable[[], Any]) -> Any:
        log(f"--- phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — every phase is reported
            import traceback

            traceback.print_exc()
            log(f"phase {name} FAILED: {e!r}")
            failed.append(name)
            return None
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
        return out

    if args.four_cards:
        phases = set((args.phases or "search,signals").split(","))
        if "search" in phases:
            run("four-cards search",
                lambda: phase_four_cards_search(args.seed))
        if "signals" in phases:
            run("four-cards signals",
                lambda: phase_four_cards_signals(args.seed))
        count = 4
    else:
        phases = set((args.phases or "process,index,serve,kernels")
                     .split(","))
        kept: Any = None
        if "process" in phases:
            run("process", lambda: phase_process(args.seed))
        if "index" in phases or "serve" in phases:
            kept = run("index", lambda: phase_index(args.seed))
        if "serve" in phases:
            if kept:
                run("serve", lambda: phase_serve(kept["index"], kept["data"]))
            else:
                failed.append("serve")
        if "kernels" in phases:
            run("kernels", lambda: phase_kernels(args.seed))
        count = 1
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
