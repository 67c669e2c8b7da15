#!/usr/bin/env python
"""Warm end-to-end pipeline benchmark: corpus -> signals -> scores -> index.

Measures the full public-library path the CLI's ``process`` command runs,
for BOTH pipeline code paths:

* **object** — the parity ``Document`` path
  (``compute_signals`` -> ``compute_dewi_scores`` -> ``build_index``);
* **columnar** — the array-native ``Corpus`` path
  (``process_corpus`` -> ``build_index_corpus``), which removes all
  per-Document Python from the hot loop.

Reports warm docs/s (after one-time jit compiles), the columnar/object
speedup, and a per-stage breakdown of the columnar run so the remaining
host cost is attributable.  Text-only corpus by default (the image story is
covered by profile_signals.py's packed-corpus rows); ``--images-per-doc``
adds a synthetic pre-decoded image corpus to every doc.

Usage:
  python scripts/profile_e2e.py --n-docs 30000 --output perf_out/e2e_pipeline.json
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


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def timed_cpu(fn, *args, **kw):
    """(result, wall_s, host_cpu_s) — CPU time separates host-bound stages
    (Python/tokenize/hash) from device-bound ones (wall >> cpu while the
    host blocks on device fetches)."""
    w0, c0 = time.perf_counter(), time.process_time()
    out = fn(*args, **kw)
    return out, time.perf_counter() - w0, time.process_time() - c0


def make_texts(n: int, rng) -> list:
    return [
        " ".join(rng.choice(WORDS, size=rng.integers(20, 60)))
        for _ in range(n)
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-docs", type=int, default=30000)
    ap.add_argument("--model", default="small")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--warm-docs", type=int, default=4096,
                    help="compile-warming corpus size")
    ap.add_argument("--images", action="store_true",
                    help="attach a synthetic pre-decoded image per doc")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--clip-image-size", type=int, default=None,
                    help="cross_modal.image_size override (run the CLIP "
                    "vision tower at corpus resolution instead of 224)")
    ap.add_argument("--skip-object", action="store_true",
                    help="measure only the columnar path")
    ap.add_argument("--output", default="e2e_metrics.json")
    args = ap.parse_args()

    import jax

    from dewi.utils.platform import apply_platform_override

    apply_platform_override()

    from dewi.config import DewiConfig
    from dewi.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    from dewi.corpus import Corpus
    from dewi.pipelines import DewiPipeline, create_document

    rng = np.random.default_rng(0)
    n = args.n_docs
    texts = make_texts(n, rng)
    ids = [f"doc{i:08d}" for i in range(n)]
    images = None
    if args.images:
        images = rng.integers(
            0, 256, (n, args.image_size, args.image_size, 3), dtype=np.uint8
        )

    cfg_dict = {
        "text": {"model": args.model, "batch_size": args.batch_size},
        "image": {"model": args.model, "batch_size": 64,
                  "image_size": args.image_size},
        "cross_modal": {"model": args.model,
                        "batch_size": args.batch_size,
                        "image_size": args.clip_image_size},
        "index": {"ann": "quantized"},
    }
    metrics: dict = {
        "n_docs": n,
        "preset": args.model,
        "modality": "text+image" if args.images else "text-only",
        "device": str(jax.devices()[0]),
    }

    def corpus():
        return Corpus(
            ids=list(ids), texts=list(texts),
            images=images if images is None else images.copy(),
        )

    pipe = DewiPipeline(DewiConfig.from_dict(cfg_dict))

    # ---- warm: one FULL-SIZE cold run so every trace the measured run
    # needs (batch shapes, redundancy blocks, index capacity) is compiled.
    # Warming on a smaller slice under-compiles and pollutes the warm
    # number with shape-change recompiles.
    wc = corpus()
    _, t_cold = timed(lambda: pipe.build_index_corpus(pipe.process_corpus(wc)))
    print(f"cold (incl. compiles, {n} docs): {t_cold:,.1f} s")
    metrics["cold_s_incl_compiles"] = round(t_cold, 1)
    del wc

    # ---- columnar warm ------------------------------------------------------
    c = corpus()
    _, t_col, cpu_col = timed_cpu(
        lambda: pipe.build_index_corpus(pipe.process_corpus(c))
    )
    metrics["columnar_warm_s"] = round(t_col, 2)
    metrics["columnar_host_cpu_s"] = round(cpu_col, 2)
    metrics["columnar_docs_per_sec"] = round(n / t_col, 1)
    metrics["columnar_extrapolated_1M_min_single_chip"] = round(
        1e6 / (n / t_col) / 60, 2
    )
    print(f"columnar: {n / t_col:,.0f} docs/s "
          f"({1e6 / (n / t_col) / 60:,.1f} min / 1M docs)")

    # ---- columnar per-stage breakdown ---------------------------------------
    from dewi.corpus import COL

    c2 = corpus()
    stage_s = {}
    tidx = np.nonzero(np.array([bool(t) for t in texts]))[0]
    # Host tokenize cost alone (it's paid twice: LM + CLIP towers).
    tok = pipe.text_entropy.tokenizer
    _, stage_s["tokenize_only"] = timed(
        lambda: tok.encode_batch_u16(
            texts, pipe.text_entropy.cfg.max_len,
            pad_to=pipe.text_entropy.cfg.max_len,
        ) if hasattr(tok, "encode_batch_u16") else tok.encode_batch(
            texts, pipe.text_entropy.cfg.max_len,
            pad_to=pipe.text_entropy.cfg.max_len,
        )
    )
    stage_cpu = {}
    t0, c0 = time.perf_counter(), time.process_time()
    means, q90s, _ = pipe.text_entropy.batch_compute_stats(texts)
    stage_s["text_entropy"] = time.perf_counter() - t0
    stage_cpu["text_entropy"] = time.process_time() - c0
    c2.signals[tidx, COL["ht_mean"]] = means[tidx]
    c2.signals[tidx, COL["ht_q90"]] = q90s[tidx]
    # Match the real columnar path: one device-resident upload, stages
    # slice HBM (io/device_images.py); falls back to host arrays when gated.
    dev = pipe._device_corpus(c2) if images is not None else None
    dev_imgs = dev[0] if dev is not None else images
    if dev is not None:
        _, stage_s["device_upload"] = timed(
            lambda: np.asarray(dev_imgs.base[0, 0, 0])  # force the put
        )
    if images is not None:
        t0, c0 = time.perf_counter(), time.process_time()
        m2, q2 = pipe.image_entropy.batch_compute_stats(dev_imgs)
        c2.signals[:, COL["hi_mean"]] = m2
        c2.signals[:, COL["hi_q90"]] = q2
        stage_s["image_entropy"] = time.perf_counter() - t0
        stage_cpu["image_entropy"] = time.process_time() - c0
    # Tower encodes run ONCE in the columnar path (I_hat + embeddings
    # share them); time them as the real pipeline does.
    t0, c0 = time.perf_counter(), time.process_time()
    t_emb = pipe.cross_modal.encode_texts(texts)
    stage_s["clip_text_encode"] = time.perf_counter() - t0
    stage_cpu["clip_text_encode"] = time.process_time() - c0
    v_emb = None
    if images is not None:
        t0 = time.perf_counter()
        v_emb = pipe.cross_modal.encode_images(dev_imgs)
        stage_s["clip_image_encode"] = time.perf_counter() - t0
        c2.signals[:, COL["I_hat"]] = np.sum(t_emb * v_emb, axis=1)
    _, stage_s["embeddings"] = timed(
        pipe.ensure_embeddings_corpus, c2, _t_emb=t_emb, _v_emb=v_emb
    )
    _, stage_s["redundancy"], stage_cpu["redundancy"] = timed_cpu(
        pipe._redundancy_corpus, c2
    )
    _, stage_s["noise"], stage_cpu["noise"] = timed_cpu(
        lambda: pipe._noise_corpus(c2, dev=dev)
    )
    scorer = pipe._make_scorer()
    c2.dewi, stage_s["score"] = timed(
        lambda: np.asarray(scorer.fit_and_score(c2.signals, mode="standard"))
    )
    _, stage_s["index_build"] = timed(pipe.build_index_corpus, c2)
    metrics["columnar_stage_s"] = {k: round(v, 2) for k, v in stage_s.items()}
    metrics["columnar_stage_host_cpu_s"] = {
        k: round(v, 2) for k, v in stage_cpu.items()
    }
    print("stage breakdown:",
          {k: f"{v:.2f}s" for k, v in stage_s.items()})
    print("stage host-CPU:",
          {k: f"{v:.2f}s" for k, v in stage_cpu.items()})

    # ---- upload/compute overlap (VERDICT r3 #6) ------------------------------
    # The columnar image path issues the device-resident corpus upload
    # (async jax.device_put) BEFORE the text stage, claiming the transfer
    # hides behind the LM forwards.  Measure it: upload alone (issue +
    # block) vs upload issued, text stage run, then block — the residual
    # block time is the UNHIDDEN part.
    if images is not None:
        import jax as _jax

        from dewi.io.device_images import DeviceImages

        _, t_alone = timed(
            lambda: _jax.block_until_ready(DeviceImages(images.copy()).base)
        )
        di2 = DeviceImages(images.copy())  # async issue
        _, t_text_during = timed(
            lambda: pipe.text_entropy.batch_compute_stats(texts)
        )
        _, t_resid = timed(lambda: _jax.block_until_ready(di2.base))
        metrics["upload_overlap"] = {
            "upload_alone_s": round(t_alone, 2),
            "text_stage_during_upload_s": round(t_text_during, 2),
            "upload_residual_after_text_s": round(t_resid, 2),
            "hidden_fraction": round(
                max(0.0, 1.0 - t_resid / max(t_alone, 1e-9)), 3
            ),
        }
        print("upload overlap:", metrics["upload_overlap"])

    # ---- object-path comparison ---------------------------------------------
    if not args.skip_object:
        docs = [
            create_document(ids[i], text=texts[i],
                            image=None if images is None else images[i])
            for i in range(n)
        ]
        def run_object():
            d2 = pipe.compute_signals(docs)
            d2 = pipe.compute_dewi_scores(d2)
            pipe.build_index(d2)

        _, t_obj, cpu_obj = timed_cpu(run_object)
        metrics["object_warm_s"] = round(t_obj, 2)
        metrics["object_host_cpu_s"] = round(cpu_obj, 2)
        metrics["object_docs_per_sec"] = round(n / t_obj, 1)
        metrics["columnar_speedup_vs_object"] = round(t_obj / t_col, 2)
        metrics["columnar_host_cpu_speedup_vs_object"] = round(
            cpu_obj / max(cpu_col, 1e-9), 2
        )
        print(f"object: {n / t_obj:,.0f} docs/s; columnar speedup "
              f"{t_obj / t_col:,.2f}x wall, "
              f"{cpu_obj / max(cpu_col, 1e-9):,.2f}x host-CPU")

    metrics["note"] = (
        "Warm = steady-state after one-time jit compiles. Full library "
        "path: signals (LM surprisal [+ MAE + CLIP diagonal] + CLIP "
        "embeddings + redundancy + noise) -> fused fit+score -> "
        "build_index(quantized)."
    )
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
