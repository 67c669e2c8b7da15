#!/usr/bin/env python
"""Signal-extraction throughput benchmark (all five DEWI signal stages).

Complements ``profile_index.py`` (which measures the index) by measuring the
other half of the ``dewi process`` pipeline — LM surprisal, MAE image
entropy, CLIP cross-modal + embeddings, redundancy, noise — against the
north-star budget (BASELINE.md: 1M docs with full signals; the per-card
budget is set by ``--budget-min``).

The combined headline assumes the worst case (every doc has text AND an
image, so every stage runs on all docs) and charges redundancy its true
O(N^2) cost at 1M docs extrapolated from the measured block throughput.

Two measurements per backbone stage:

* **device** — steady-state throughput of the jitted kernels with
  device-resident inputs (pure device compute; what a host-attached feed
  sustains);
* **host** — the estimator public path including host tokenization and
  host->device transfer.

Usage:
  python scripts/profile_signals.py --n-docs 8192 --model small
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

WORDS = (
    "alpha beta gamma delta entropy index corpus signal token image model "
    "robust search weight noise data surprise useful document query"
).split()

TARGET_N = 1_000_000


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-docs", type=int, default=8192)
    ap.add_argument("--n-images", type=int, default=512)
    ap.add_argument("--n-pairs", type=int, default=1024)
    ap.add_argument("--redundancy-n", type=int, default=100_000)
    ap.add_argument("--model", default="small", help="backbone preset")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--skip", default="", help="comma list: text,image,clip,"
                    "redundancy,noise,ingest")
    ap.add_argument("--io-threads", type=int, default=8)
    ap.add_argument("--jpeg-size", type=int, default=512,
                    help="stored resolution of the synthetic ingest JPEGs")
    ap.add_argument("--output", default="signals_metrics.json")
    ap.add_argument("--budget-min", type=float, default=80.0,
                    help="per-card minutes budget for 1M docs")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))

    import jax

    from dewi.utils.platform import apply_platform_override

    apply_platform_override()

    from dewi.signals import (
        CrossModalDependency,
        ImageEntropyEstimator,
        NoiseEstimator,
        TextEntropyEstimator,
    )
    from dewi.signals.redundancy import max_offdiag_similarity

    rng = np.random.default_rng(0)
    texts = [
        " ".join(rng.choice(WORDS, size=rng.integers(20, 60)))
        for _ in range(args.n_docs)
    ]
    print(f"Device: {jax.devices()[0]}")
    metrics: dict = {"model": args.model, "device": str(jax.devices()[0]),
                     "assumption": "every doc has text AND an image"}
    per_doc_s = 0.0  # accumulated worst-case seconds per document

    import jax.numpy as jnp

    def device_rate(fn, per_call_docs: int, iters: int = 4) -> float:
        """Steady-state docs/sec of a pre-staged jitted call."""
        jax.block_until_ready(fn())  # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        return per_call_docs * iters / (time.perf_counter() - t0)

    # ---- text entropy (LM surprisal) --------------------------------------
    if "text" not in skip:
        est = TextEntropyEstimator(model_name=args.model,
                                   batch_size=args.batch_size, max_length=512)
        est.batch_compute_stats(texts)  # warm: compiles every bucket shape
        _, text_s = timed(est.batch_compute_stats, texts)
        host_dps = args.n_docs / text_s

        # Device-resident: one staged superbatch at the dominant bucket.
        S, bs = est.superbatch, est.batch_size
        ids, mask = est.tokenizer.encode_batch(
            texts[:bs], est.cfg.max_len, pad_to=256
        )
        ids3 = jnp.asarray(np.broadcast_to(ids, (S,) + ids.shape))
        mask3 = jnp.asarray(np.broadcast_to(mask, (S,) + mask.shape))
        dps = device_rate(
            lambda: est._score_super(est.params, ids3, mask3), S * bs
        )
        per_doc_s += 1.0 / dps
        metrics["text_docs_per_sec_device"] = round(dps, 1)
        metrics["text_docs_per_sec_host"] = round(host_dps, 1)
        metrics["text_1M_s_single_chip"] = round(TARGET_N / dps, 1)
        print(f"text ({args.model}): device {dps:,.0f} docs/s "
              f"(host path {host_dps:,.0f}) -> 1M: {TARGET_N / dps:,.0f}s")

    # ---- image entropy (MAE reconstruction) --------------------------------
    if "image" not in skip:
        imgs = rng.random(
            (args.n_images, args.image_size, args.image_size, 3)
        ).astype(np.float32)
        ie = ImageEntropyEstimator(model_name=args.model, batch_size=64,
                                   image_size=args.image_size)
        ie.batch_compute_stats(imgs[:128])
        _, img_s = timed(ie.batch_compute_stats, imgs)
        host_dps = args.n_images / img_s

        S = ie.superbatch
        img4 = jnp.asarray(
            np.broadcast_to(imgs[:64], (S, 64) + imgs.shape[1:])
        )
        rngs = jax.random.split(jax.random.PRNGKey(0), S)
        dps = device_rate(
            lambda: ie._stats_super(ie.params, img4, rngs), S * 64
        )
        per_doc_s += 1.0 / dps
        metrics["image_docs_per_sec_device"] = round(dps, 1)
        metrics["image_docs_per_sec_host"] = round(host_dps, 1)
        metrics["image_1M_s_single_chip"] = round(TARGET_N / dps, 1)
        print(f"image ({args.model}): device {dps:,.0f} imgs/s "
              f"(host path {host_dps:,.0f}) -> 1M: {TARGET_N / dps:,.0f}s")

    # ---- cross-modal + embeddings (CLIP both towers) -----------------------
    if "clip" not in skip:
        cm = CrossModalDependency(model_name=args.model, batch_size=128)
        pair_texts = texts[: args.n_pairs]
        pair_imgs = rng.random(
            (args.n_pairs, cm.cfg.image_size, cm.cfg.image_size, 3)
        ).astype(np.float32)
        cm.batch_compute(pair_texts[:256], list(pair_imgs[:256]))  # warm
        _, clip_s = timed(cm.batch_compute, pair_texts, list(pair_imgs))
        host_dps = args.n_pairs / clip_s

        S, bs = cm.superbatch, cm.batch_size
        ids, mask = cm.tokenizer.encode_batch(
            pair_texts[:bs], cm.cfg.text_len, pad_to=cm.cfg.text_len
        )
        ids3 = jnp.asarray(np.broadcast_to(ids, (S,) + ids.shape))
        mask3 = jnp.asarray(np.broadcast_to(mask, (S,) + mask.shape))
        img4 = jnp.asarray(np.broadcast_to(
            pair_imgs[:bs].astype(np.float32),
            (S, bs, cm.cfg.image_size, cm.cfg.image_size, 3),
        ))

        def clip_call():
            t = cm._encode_text_super(cm.params, ids3, mask3)
            v = cm._encode_image_super(cm.params, img4)
            return t, v

        dps = device_rate(clip_call, S * bs)
        per_doc_s += 1.0 / dps
        metrics["clip_pairs_per_sec_device"] = round(dps, 1)
        metrics["clip_pairs_per_sec_host"] = round(host_dps, 1)
        metrics["clip_1M_s_single_chip"] = round(TARGET_N / dps, 1)
        print(f"clip ({args.model}): device {dps:,.0f} pairs/s "
              f"(host path {host_dps:,.0f}) -> 1M: {TARGET_N / dps:,.0f}s")

    # ---- redundancy (embedding mode, measured at the REAL target scale) ----
    if "redundancy" not in skip:
        # Corpus generated on device (1M x dim f32 = 1 GB in HBM); the
        # chunked running-max kernel never materializes a [block, N] tile,
        # so the full 1M x 1M scan fits and runs directly — no extrapolation.
        emb = jax.random.normal(
            jax.random.PRNGKey(0), (args.redundancy_n, args.dim), jnp.float32
        )
        jax.block_until_ready(emb)
        max_offdiag_similarity(emb, block=4096)  # warm (incl. compile)
        _, red_s = timed(max_offdiag_similarity, emb, 4096)
        red_1m = red_s * (TARGET_N / args.redundancy_n) ** 2
        per_doc_s += red_1m / TARGET_N
        metrics["redundancy_n"] = args.redundancy_n
        metrics["redundancy_s"] = round(red_s, 2)
        metrics["redundancy_1M_s_single_chip"] = round(red_1m, 1)
        print(f"redundancy: {args.redundancy_n} docs in {red_s:.2f}s "
              f"-> 1M: {red_1m:,.0f}s")

    # ---- noise (host-side heuristics) ---------------------------------------
    if "noise" not in skip:
        ne = NoiseEstimator()
        _, noise_s = timed(
            ne.batch_compute, texts=texts, images=[None] * len(texts)
        )
        dps = args.n_docs / noise_s
        per_doc_s += 1.0 / dps
        metrics["noise_docs_per_sec"] = round(dps, 1)
        print(f"noise: {dps:,.0f} docs/s -> 1M: {TARGET_N / dps:,.0f}s")

    # ---- ingestion: the from-JPEG-files end-to-end image path ----------------
    # The reference decodes inline per stage per image; this framework's
    # loader (dewi/io) adds JPEG draft decode, threads, and prefetch
    # overlapped with device compute.  Measured from real files on disk.
    if "ingest" not in skip:
        try:
            import tempfile

            from PIL import Image

            from dewi.io import decode_batch

            n_files = min(args.n_images, 512)
            with tempfile.TemporaryDirectory() as td:
                paths = []
                for i in range(n_files):
                    arr = (rng.random((args.jpeg_size, args.jpeg_size, 3))
                           * 255).astype(np.uint8)
                    p = Path(td) / f"{i:04d}.jpg"
                    Image.fromarray(arr).save(p, quality=90)
                    paths.append(str(p))

                def naive_decode():  # reference-style: full decode + f32
                    for p in paths:
                        with Image.open(p) as img:
                            np.asarray(
                                img.convert("RGB").resize(
                                    (args.image_size, args.image_size)
                                ),
                                dtype=np.float32,
                            )

                _, t_naive = timed(naive_decode)
                _, t_draft1 = timed(
                    decode_batch, paths, args.image_size, 1
                )
                _, t_draftN = timed(
                    decode_batch, paths, args.image_size, args.io_threads
                )
                metrics["ingest_jpeg_px"] = args.jpeg_size
                metrics["ingest_naive_imgs_per_sec"] = round(
                    n_files / t_naive, 1
                )
                metrics["ingest_draft_imgs_per_sec_1thread"] = round(
                    n_files / t_draft1, 1
                )
                metrics[
                    f"ingest_draft_imgs_per_sec_{args.io_threads}threads"
                ] = round(n_files / t_draftN, 1)
                print(
                    f"ingest ({args.jpeg_size}px JPEG -> {args.image_size}): "
                    f"naive {n_files / t_naive:,.0f}/s, draft "
                    f"{n_files / t_draft1:,.0f}/s, draft x"
                    f"{args.io_threads} threads {n_files / t_draftN:,.0f}/s"
                )

                if "image" not in skip:
                    # True end-to-end: files -> loader prefetch -> MAE stats.
                    ie2 = ImageEntropyEstimator(
                        model_name=args.model, batch_size=64,
                        image_size=args.image_size,
                        io_threads=args.io_threads,
                    )
                    ie2.batch_compute_stats(paths[:128])  # warm/compile
                    _, t_e2e = timed(ie2.batch_compute_stats, paths)
                    metrics["image_docs_per_sec_from_files"] = round(
                        n_files / t_e2e, 1
                    )
                    print(f"image end-to-end from JPEG files: "
                          f"{n_files / t_e2e:,.0f} docs/s")

                    # Packed corpus: decode ONCE offline, mmap at run time
                    # (dewi.io.packed) — the production image-ingest
                    # path; signal runs become device-bound.
                    from dewi.io.packed import PackedImages, pack_images

                    pack_path = Path(td) / "corpus.npy"
                    _, t_pack = timed(
                        pack_images, paths, args.image_size, pack_path
                    )
                    metrics["pack_imgs_per_sec"] = round(n_files / t_pack, 1)
                    pack = PackedImages(pack_path)
                    ie2.batch_compute_stats(pack.data[:128])  # warm shape
                    _, t_packed = timed(ie2.batch_compute_stats, pack.data)
                    metrics["image_docs_per_sec_packed"] = round(
                        n_files / t_packed, 1
                    )
                    # Decompose the packed path: host FEED rate (mmap slice
                    # + batch assembly, what replaces decode), measured
                    # host->device bandwidth, and the device rate above:
                    # the end-to-end packed rate is bounded by
                    # min(feed, transfer, device).
                    def feed():
                        bs = 64
                        for s in range(0, len(pack), bs):
                            np.ascontiguousarray(pack.data[s : s + bs])

                    _, t_feed = timed(feed)
                    metrics["packed_feed_imgs_per_sec"] = round(
                        n_files / t_feed, 1
                    )
                    img_bytes = args.image_size * args.image_size * 3
                    probe = np.zeros((64, args.image_size, args.image_size,
                                      3), np.uint8)
                    jax.block_until_ready(jnp.asarray(probe))  # warm
                    _, t_xfer = timed(
                        lambda: jax.block_until_ready(jnp.asarray(probe))
                    )
                    mbps = 64 * img_bytes / t_xfer / 2**20
                    metrics["host_to_device_MBps_measured"] = round(mbps, 1)
                    metrics["image_e2e_production_bound_imgs_per_sec"] = (
                        round(min(n_files / t_feed,
                                  metrics["image_docs_per_sec_device"]), 1)
                    )
                    print(
                        f"pack once: {n_files / t_pack:,.0f} imgs/s; "
                        f"packed e2e here: {n_files / t_packed:,.0f} docs/s "
                        f"(transfer-bound, link {mbps:,.0f} MB/s); host feed "
                        f"{n_files / t_feed:,.0f} imgs/s -> production bound "
                        f"{metrics['image_e2e_production_bound_imgs_per_sec']:,.0f}/s"
                    )
        except ImportError:
            print("ingest: PIL unavailable, skipped")

    # ---- combined headline ---------------------------------------------------
    total_1m_s = per_doc_s * TARGET_N
    metrics["full_signals_1M_s_single_chip"] = round(total_1m_s, 1)
    metrics["full_signals_1M_min_single_chip"] = round(total_1m_s / 60, 2)
    metrics["budget_min_single_chip"] = args.budget_min
    metrics["within_budget"] = bool(total_1m_s / 60 < args.budget_min)
    print(f"FULL SIGNALS 1M docs single-chip: {total_1m_s / 60:,.1f} min "
          f"(budget {args.budget_min} min) -> "
          f"{'OK' if metrics['within_budget'] else 'OVER'}")

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
