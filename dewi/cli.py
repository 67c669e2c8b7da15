"""Command-line interface: ``dewi config | process | search``.

Command surface and artifact layout parity with the reference CLI
(reference cli.py:46-663): ``config`` presets + overwrite guard, ``process``
(YAML config -> documents -> signals -> scores -> batched JSONL/npz/summary/
metadata with timestamped backup), ``search`` (index dir + query -> ranked
JSON), and the ``DEWI_TEST_MODE`` env fake mode (cli.py:15-18) that CI uses.

Fixes folded in (SURVEY.md §2.4):
* ``search`` encodes text queries with the CLIP text tower (item 6 — the
  reference passed the raw string into a vector API), and also accepts a
  ``.npy`` query vector path;
* ``process`` additionally saves a ready-to-search index under
  ``<out>/index/`` (item 8 — the reference's own tests expected it).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import uuid
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import click


def _test_mode() -> bool:
    return os.getenv("DEWI_TEST_MODE", "").lower() in ("1", "true", "yes")


CONTEXT_SETTINGS = {"help_option_names": ["-h", "--help"], "max_content_width": 120}


@click.group(context_settings=CONTEXT_SETTINGS)
@click.version_option(version="0.1.0", prog_name="dewi")
def cli() -> None:
    """DEWI: entropy-weighted index for text+image corpora, accelerator-native."""
    # Persistent XLA compile cache: the cold-start compile cost (minutes at
    # 1M-doc scale) is paid once per machine, not once per invocation.
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@cli.command()
@click.option("--output", "-o", type=click.Path(), help="Output config file path")
@click.option("--overwrite", is_flag=True, help="Overwrite output file if it exists")
@click.option(
    "--preset",
    type=click.Choice(["default", "web", "product", "balanced"]),
    default="default",
    help="Configuration preset",
)
def config(output: Optional[str], overwrite: bool, preset: str) -> None:
    """Generate a configuration file (parity: reference cli.py:53-119)."""
    import yaml

    from .config import apply_preset, get_default_config

    cfg = apply_preset(get_default_config(), preset)
    text = yaml.dump(cfg.to_dict(), default_flow_style=False, sort_keys=False)
    if output:
        path = Path(output)
        if path.exists() and not overwrite:
            click.echo(
                f"Error: File {output} already exists. Use --overwrite to replace it.",
                err=True,
            )
            sys.exit(1)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text, encoding="utf-8")
        click.echo(f"Configuration saved to {path}")
    else:
        click.echo("# DEWI Configuration")
        click.echo(f"# Preset: {preset}\n")
        click.echo(text)


# ---------------------------------------------------------------------------
# process
# ---------------------------------------------------------------------------


@cli.command()
@click.argument("config_path", type=click.Path(exists=True, dir_okay=False))
@click.argument("output_dir", type=click.Path(file_okay=False))
@click.option("--texts", type=click.Path(exists=True),
              help="Text file or directory of text files")
@click.option("--images", type=click.Path(exists=True),
              help="Directory containing images, or a packed corpus "
                   "(.npy from `dewi pack-images`: zero run-time "
                   "decode, mmap-backed)")
@click.option("--embeddings", type=click.Path(exists=True),
              help="npz file with doc_ids + embeddings arrays")
@click.option("--batch-size", type=int, help="Override batch size")
@click.option("--device", type=str,
              help="Accepted for parity; JAX owns device placement")
@click.option("--delta", type=float, help="Override scoring delta")
@click.option("--mode", type=click.Choice(["standard", "conditional"]),
              help="Scoring mode")
@click.option("--checkpoint-dir", type=click.Path(),
              help="Stage-checkpoint directory for resumable signal runs")
@click.option("--shard-size", type=int,
              help="Process the corpus in resumable shards of this many docs")
def process(
    config_path: str,
    output_dir: str,
    texts: Optional[str],
    images: Optional[str],
    embeddings: Optional[str],
    batch_size: Optional[int],
    device: Optional[str],
    delta: Optional[float],
    mode: Optional[str],
    checkpoint_dir: Optional[str],
    shard_size: Optional[int],
) -> None:
    """Compute DEWI signals + scores for a corpus and write artifacts."""
    try:
        import yaml

        from .config import DewiConfig
        from .pipelines import DewiPipeline

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)

        with open(config_path, "r", encoding="utf-8") as f:
            cfg = DewiConfig.from_dict(yaml.safe_load(f) or {})
        if batch_size:
            cfg.text.batch_size = batch_size
            cfg.image.batch_size = batch_size
            cfg.cross_modal.batch_size = batch_size
        if delta is not None:
            cfg.scoring.delta = float(delta)
        if mode is not None:
            cfg.scoring.mode = mode
        if device:
            click.echo(
                f"Note: --device {device!r} ignored; JAX places arrays on "
                "the available accelerator."
            )

        documents = _load_documents(
            texts, images, embeddings, max_workers=cfg.runtime.io_threads
        )
        if not documents:
            raise click.ClickException(
                "No documents to process. Provide --texts and/or --images"
            )
        click.echo(f"Processing {len(documents)} documents...")

        if _test_mode():
            _save_results(None, out)  # fabricates mock artifacts
            click.echo(f"✓ Processed {len(documents)} documents. "
                       f"Results saved to {out}")
            return

        pipeline = DewiPipeline(cfg)
        # Shard automatically when the corpus exceeds the configured shard
        # size (runtime.shard_size), when periodic checkpointing is requested
        # (runtime.checkpoint_every = docs between checkpoint flushes; each
        # shard's signal stages checkpoint independently), or when explicitly
        # asked for via --shard-size.
        if not shard_size and cfg.runtime.checkpoint_every > 0:
            shard_size = cfg.runtime.checkpoint_every
            if checkpoint_dir is None:
                checkpoint_dir = str(out / "checkpoints")
        if not shard_size and len(documents) > cfg.runtime.shard_size:
            shard_size = cfg.runtime.shard_size

        from contextlib import nullcontext

        from .utils.profiling import xla_trace

        trace_ctx = (
            xla_trace(str(out / "profile")) if cfg.runtime.profile
            else nullcontext()
        )
        corpus = None
        with trace_ctx:
            if shard_size:
                # Sharded columnar stream: per-shard signals + resume
                # (.npz checkpoints keyed to a content digest), global
                # redundancy + fused fit-and-score — the 1M-doc flow with
                # no per-Document Python in the hot loop.
                corpus = _as_corpus(documents, texts, images, embeddings)
                pipeline.process_stream_corpus(
                    corpus, shard_size=shard_size, progress=True,
                    checkpoint_dir=checkpoint_dir,
                    delta=cfg.scoring.delta, mode=cfg.scoring.mode,
                )
                docs = corpus.apply_to_documents(documents)
            elif checkpoint_dir:
                # Stage checkpoints are keyed to the Document corpus digest.
                docs = pipeline.compute_signals(
                    documents, progress=True, checkpoint_dir=checkpoint_dir
                )
                docs = pipeline.compute_dewi_scores(
                    docs, delta=cfg.scoring.delta, mode=cfg.scoring.mode
                )
            else:
                # Columnar fast path: signals/scores/index flow as arrays
                # (no per-Document Python in the hot loop); Documents are
                # materialized only for artifact serialization.
                corpus = _as_corpus(documents, texts, images, embeddings)
                pipeline.process_corpus(
                    corpus, delta=cfg.scoring.delta, mode=cfg.scoring.mode,
                    progress=True,
                )
                # Re-attach results to the loaded documents (they keep
                # metadata/image paths the column store doesn't carry).
                docs = corpus.apply_to_documents(documents)
        if cfg.runtime.profile:
            click.echo(f"✓ XLA trace written to {out / 'profile'}")
        _save_results(docs, out)
        try:
            index = (
                pipeline.build_index_corpus(corpus)
                if corpus is not None else pipeline.build_index(docs)
            )
            index.save(out / "index")
            click.echo(f"✓ Index saved to {out / 'index'}")
        except Exception as e:  # noqa: BLE001 — index is best-effort extra
            click.echo(f"Warning: index build failed: {e}", err=True)
        click.echo(
            f"✓ Processed {len(docs)} documents. Results saved to {out}"
        )
    except click.ClickException:
        raise
    except Exception as e:  # noqa: BLE001
        if _test_mode():
            import traceback

            traceback.print_exc()
        raise click.ClickException(f"Error during processing: {e}")


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


@cli.command()
@click.argument("index_dir", type=click.Path(exists=True, file_okay=False))
@click.argument("query")
@click.option("--k", type=int, default=10, help="Number of results")
@click.option("--eta", type=float, help="Weight for DEWI score (0-1)")
@click.option("--entropy-pref", type=float, help="Entropy preference weight")
@click.option("--output", "-o", type=click.Path(), help="JSON output path")
@click.option("--test-mode", is_flag=True, help="Run with mock data")
def search(
    index_dir: str,
    query: str,
    k: int,
    eta: Optional[float],
    entropy_pref: Optional[float],
    output: Optional[str],
    test_mode: bool,
) -> None:
    """Search a DEWI index with a text query or a ``.npy`` vector."""
    fake = test_mode or _test_mode()
    # Reference defaults for the search CLI (reference cli.py:256-262).
    eta = 0.5 if eta is None else eta
    entropy_pref = 1.0 if entropy_pref is None else entropy_pref
    try:
        import numpy as np

        from .index import DewiIndex

        click.echo(f"Searching for '{query}'...")
        if fake:
            results = [
                (f"doc_{i}", 0.9 - 0.05 * i,
                 {"dewi": 0.8 - 0.04 * i, "ht_mean": 0.5, "hi_mean": 0.4})
                for i in range(min(k, 5))
            ]
        else:
            index = DewiIndex.load(index_dir)
            if query.endswith(".npy") and Path(query).exists():
                qvec = np.load(query).astype(np.float32).reshape(-1)
            else:
                qvec = _encode_query_text(query, index)
            results = index.search(qvec, k=k, eta=eta,
                                   entropy_pref=entropy_pref)

        formatted: List[Dict[str, Any]] = []
        for doc_id, score, payload in results:
            if hasattr(payload, "to_dict"):
                p = payload.to_dict()
            else:
                p = dict(payload)
            formatted.append(
                {
                    "id": doc_id,
                    "score": float(score),
                    "dewi_score": p.get("dewi"),
                    "entropy": (p.get("ht_mean", 0.0) + p.get("hi_mean", 0.0))
                    / 2,
                    "metadata": {},
                    "text": "",
                }
            )
        if not formatted:
            click.echo("No results found.")
            return
        blob = json.dumps(formatted, indent=2)
        if output:
            path = Path(output)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(blob, encoding="utf-8")
            click.echo(f"✓ Results saved to {path}")
        else:
            click.echo(blob)
        if fake:
            click.echo("\n[TEST MODE] Results are simulated")
    except Exception as e:  # noqa: BLE001
        click.echo(f"Error during search: {e}", err=True)
        if fake:
            import traceback

            traceback.print_exc()
        sys.exit(1)


_QUERY_ENCODERS: Dict[str, Any] = {}  # provenance-keyed cache (eval reuse)


def _encode_query_text(query: str, index: Any) -> Any:
    """Text -> query embedding via the CLIP text tower (fixes §2.4 item 6)."""
    return _query_encoder_for_index(index).encode_texts([query])[0]


def _query_encoder_for_index(index: Any) -> Any:
    """Reconstruct the query encoder an index's embeddings came from.

    Built from the provenance the index recorded at build time (model
    preset, tokenizer, seed, checkpoint) so query vectors live in the same
    space as the corpus embeddings; shared by CLI search/eval and the
    serving layer (:mod:`dewi.serve`).  Indexes without a provenance
    record (pre-provenance saves, or hand-built) fall back to the old
    dim-matching heuristic with a warning.
    """
    from .signals.cross_modal import CrossModalDependency

    prov = getattr(index, "encoder", None)
    if prov and prov.get("source") == "external":
        raise click.ClickException(
            "Index embeddings were supplied externally (no encoder "
            "provenance); text queries cannot be encoded consistently — "
            "pass a .npy query vector embedded by the same external model."
        )
    if prov:
        ckpt = prov.get("checkpoint")
        if ckpt and not Path(ckpt).exists():
            raise click.ClickException(
                f"Index was embedded with checkpoint {ckpt!r}, which does not "
                "exist here; restore it (or pass a .npy query vector)."
            )
        if ckpt:
            from .models.registry import checkpoint_fingerprint

            want = prov.get("checkpoint_fingerprint")
            have = checkpoint_fingerprint(ckpt)
            if want and have and want != have:
                click.echo(
                    f"Warning: checkpoint {ckpt} changed since the index was "
                    f"built (fingerprint {have} != recorded {want}); query "
                    "embeddings may not match the corpus.",
                    err=True,
                )
        key = json.dumps(prov, sort_keys=True, default=str)
        enc = _QUERY_ENCODERS.get(key)
        if enc is None:
            enc = CrossModalDependency(
                model_name=prov.get("model", "small"),
                tokenizer=prov.get("tokenizer", "byte"),
                seed=int(prov.get("seed", 0)),
                checkpoint=ckpt,
            )
            _QUERY_ENCODERS[key] = enc
        return enc

    from .models.registry import CLIP_PRESETS

    click.echo(
        "Warning: index has no encoder provenance record; guessing the "
        "query encoder from the embedding dim (rebuild the index with "
        "`dewi process` to record provenance).",
        err=True,
    )
    for preset in ("tiny", "small", "base"):
        if CLIP_PRESETS[preset]["d_embed"] == index.dim:
            return CrossModalDependency(model_name=preset)
    raise click.ClickException(
        f"Index dim {index.dim} matches no CLIP text-tower preset; pass a "
        ".npy query vector instead."
    )


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


@cli.command()
@click.argument("index_dir", type=click.Path(exists=True, file_okay=False))
@click.option("--host", default="127.0.0.1", help="Bind address")
@click.option("--port", type=int, default=8321, help="Bind port (0 = any)")
@click.option("--window-ms", type=float, default=2.0,
              help="Micro-batch coalescing window")
@click.option("--max-batch", type=int, default=256,
              help="Max queries fused into one device dispatch")
@click.option("--backend", default=None,
              type=click.Choice(["exact", "quantized", "ivf"]),
              help="Serve from a different index tier than the saved one "
                   "(re-tiers the stored corpus in memory; e.g. serve an "
                   "exact-saved index from the faster int8 tier)")
def serve(index_dir: str, host: str, port: int, window_ms: float,
          max_batch: int, backend: Optional[str]) -> None:
    """Serve a DEWI index over HTTP with micro-batched device dispatch.

    Endpoints: POST /search {"text"|"vector", "k", "eta", "entropy_pref"},
    POST /search_batch {"queries": [...]}, GET /healthz.  Concurrent
    requests coalesce into one fused ``search_batch`` call (~10x the
    per-query throughput of solo dispatches — see bench.py extras).
    """
    from .index import DewiIndex
    from .serve import SearchServer

    index = DewiIndex.load(index_dir)
    if backend is not None:
        from .serve import retier_index

        was = type(index._backend).__name__
        index = retier_index(index, backend)
        if type(index._backend).__name__ != was:
            click.echo(f"Re-tiered {was} -> {backend}")
    server = SearchServer(index, host=host, port=port,
                          window_ms=window_ms, max_batch=max_batch)
    click.echo(f"Serving {len(index)} docs (dim {index.dim}) on "
               f"http://{host}:{server.port} — Ctrl-C to stop")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        click.echo("Shutting down.")
        server.shutdown()


# ---------------------------------------------------------------------------
# import-weights
# ---------------------------------------------------------------------------


@cli.command(name="pack-images")
@click.argument("images_dir", type=click.Path(exists=True, file_okay=False))
@click.argument("out_path", type=click.Path())
@click.option("--size", type=int, default=224,
              help="Packed square resolution (use the largest any signal "
                   "stage needs; smaller sizes derive by downscale)")
@click.option("--workers", type=int, default=None,
              help="Decode processes (default: cpu_count-1 when >2 cores)")
def pack_images_cmd(images_dir: str, out_path: str, size: int,
                    workers: Optional[int]) -> None:
    """Pre-decode an image directory into a packed mmap corpus.

    One offline decode pass writes OUT_PATH (.npy uint8 [N, size, size, 3])
    plus a .json sidecar; `process --images OUT_PATH` then ingests the
    corpus with ZERO run-time decode (the file is memory-mapped).  At
    corpus scale host JPEG decode is the end-to-end bottleneck (~300
    imgs/s/core vs >20k imgs/s device-side MAE), so packing once turns
    every later signals run from decode-bound into device-bound.
    """
    from .io.packed import pack_images
    from .utils.progress import ProgressMeter

    p = Path(images_dir)
    image_files: List[Path] = []
    for pattern in IMAGE_GLOBS:
        image_files.extend(sorted(p.glob(pattern)))
    if not image_files:
        raise click.ClickException(f"No images found under {images_dir}")
    meter = ProgressMeter(len(image_files), "pack", enabled=True)
    meta = pack_images([str(f) for f in image_files], size, out_path,
                       workers=workers, progress=meter.update)
    meter.close()
    # Row order == sorted file order; record it for id mapping.
    manifest = Path(str(out_path) + ".manifest.json")
    manifest.write_text(json.dumps([str(f) for f in image_files]))
    click.echo(json.dumps({**meta, "out": str(out_path),
                           "manifest": str(manifest)}))


@cli.command(name="import-weights")
@click.argument("source")
@click.argument("out_path", type=click.Path())
@click.option("--kind", type=click.Choice(["gpt2", "clip", "vit-mae"]),
              required=True, help="Architecture family of the HF checkpoint")
def import_weights(source: str, out_path: str, kind: str) -> None:
    """Convert an HF checkpoint (local dir or cached hub name) to a
    DEWI checkpoint loadable via the config ``checkpoint:`` fields.

    Example:  dewi import-weights gpt2 gpt2.msgpack --kind gpt2
    then set  text: {model: gpt2, tokenizer: gpt2, checkpoint: gpt2.msgpack}
    """
    from .models.import_hf import convert_pretrained

    try:
        info = convert_pretrained(source, kind, out_path)
    except ImportError as e:
        raise click.ClickException(f"torch/transformers required: {e}")
    except Exception as e:  # noqa: BLE001
        raise click.ClickException(f"Conversion failed: {e}")
    click.echo(f"✓ Imported {kind} weights from {source} -> {out_path}")
    click.echo(json.dumps(info))


# ---------------------------------------------------------------------------
# sample
# ---------------------------------------------------------------------------


@cli.command(name="sample")
@click.argument("processed_dir", type=click.Path(exists=True, file_okay=False))
@click.argument("k", type=int)
@click.option("--tau", type=float, default=1.0,
              help="DEWI^tau temperature (0 = uniform)")
@click.option("--submodular", is_flag=True,
              help="Facility-location coverage pick instead of sampling")
@click.option("--seed", type=int, default=0)
@click.option("--output", "-o", type=click.Path(),
              help="Write selected doc ids (one per line)")
def sample_cmd(processed_dir: str, k: int, tau: float,
               submodular: bool, seed: int,
               output: Optional[str]) -> None:
    """Select K training docs from a ``dewi process`` output directory.

    Implements the TrainingSamplingConfig capability (p(doc) ∝ DEWI^tau, or
    submodular coverage when --submodular) over the saved signals summary
    and embeddings.
    """
    import numpy as np

    from .sampling import training_sample

    pdir = Path(processed_dir)
    summary_path = pdir / "signals_summary.json"
    if not summary_path.exists():
        raise click.ClickException(f"No signals_summary.json in {pdir}")
    summary = json.loads(summary_path.read_text(encoding="utf-8"))
    ids = [str(r["id"]) for r in summary]
    dewi = np.array(
        [float(r.get("dewi_score") or 0.0) for r in summary], np.float32
    )

    embeddings = None
    if submodular:
        by_id = {}
        for npz in sorted(pdir.glob("embeddings*.npz")):
            data = np.load(npz, allow_pickle=True)
            for d, e in zip(data["doc_ids"], data["embeddings"]):
                by_id[str(d)] = np.asarray(e, np.float32)
        missing = [i for i in ids if i not in by_id]
        if missing:
            raise click.ClickException(
                f"--submodular needs embeddings for every doc "
                f"({len(missing)} missing)"
            )
        embeddings = np.stack([by_id[i] for i in ids])

    picks = training_sample(dewi, embeddings, k=min(k, len(ids)), tau=tau,
                            use_submodular=submodular, seed=seed)
    selected = [ids[int(i)] for i in picks]
    if output:
        Path(output).write_text("\n".join(selected) + "\n", encoding="utf-8")
        click.echo(f"✓ {len(selected)} doc ids saved to {output}")
    else:
        for doc_id in selected:
            click.echo(doc_id)


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


@cli.command(name="eval")
@click.argument("index_dir", type=click.Path(exists=True, file_okay=False))
@click.argument("queries", type=click.Path(exists=True, dir_okay=False))
@click.argument("qrels", type=click.Path(exists=True, dir_okay=False))
@click.option("--config", "config_path", type=click.Path(exists=True),
              help="YAML config providing the eval section")
@click.option("--eta", type=float, default=0.0)
@click.option("--entropy-pref", type=float, default=0.0)
@click.option("--output", "-o", type=click.Path(), help="Report JSON path")
def eval_cmd(index_dir: str, queries: str, qrels: str,
             config_path: Optional[str], eta: float, entropy_pref: float,
             output: Optional[str]) -> None:
    """Run the EvalConfig metric suite against a saved index.

    QUERIES: ``.npz`` with ``query_ids`` + ``embeddings`` arrays (or
    ``texts`` to encode with the CLIP text tower).  QRELS: JSON mapping
    query id -> list of relevant doc ids.
    """
    import numpy as np

    from .config import DewiConfig
    from .eval import evaluate_index
    from .index import DewiIndex

    cfg = None
    if config_path:
        cfg = DewiConfig.from_yaml(config_path).eval
    index = DewiIndex.load(index_dir)
    data = np.load(queries, allow_pickle=True)
    qids = [str(q) for q in data["query_ids"]]
    if "embeddings" in data:
        qvecs = np.asarray(data["embeddings"], np.float32)
    elif "texts" in data:
        qvecs = np.stack(
            [_encode_query_text(str(t), index) for t in data["texts"]]
        )
    else:
        raise click.ClickException("queries npz needs embeddings or texts")
    with open(qrels, encoding="utf-8") as f:
        ground_truth = json.load(f)
    report = evaluate_index(
        index, qvecs, ground_truth, query_ids=qids, config=cfg,
        eta=eta, entropy_pref=entropy_pref,
    )
    blob = json.dumps(report, indent=2)
    if output:
        Path(output).write_text(blob, encoding="utf-8")
        click.echo(f"✓ Report saved to {output}")
    else:
        click.echo(blob)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def create_document(text: Optional[str] = None,
                    metadata: Optional[Dict] = None) -> Any:
    """UUID doc factory (parity: reference cli.py:330-333)."""
    from .pipelines import Document

    doc = Document(doc_id=str(uuid.uuid4()), text=text)
    doc.metadata = metadata or {}  # loose attribute, like the reference
    return doc


TEXT_EXTS = (".txt", ".md", ".json", ".jsonl")
IMAGE_GLOBS = ("**/*.jpg", "**/*.jpeg", "**/*.png")


def _load_documents(
    texts_path: Optional[str],
    images_dir: Optional[str],
    embeddings_path: Optional[str],
    max_workers: int = 4,
) -> List[Any]:
    """Load documents from text files / image dirs / embedding archives
    (parity: reference cli.py:335-457, incl. the thread-pool text reads)."""
    if _test_mode():
        return [
            create_document(text=f"Test document {i}",
                            metadata={"test": True, "id": i})
            for i in range(5)
        ]

    from concurrent.futures import ThreadPoolExecutor

    documents: List[Any] = []

    if texts_path:
        p = Path(texts_path)
        files: List[Path] = []
        if p.is_file() and p.suffix.lower() in TEXT_EXTS:
            files.append(p)
        elif p.is_dir():
            for ext in TEXT_EXTS:
                files.extend(sorted(p.glob(f"**/*{ext}")))

        def read_one(fp: Path) -> str:
            try:
                content = fp.read_text(encoding="utf-8", errors="replace")
                return create_document(
                    text=content,
                    metadata={"source": str(fp), "type": "text"},
                )
            except Exception as e:  # noqa: BLE001
                click.echo(f"Error reading {fp}: {e}", err=True)
                return None

        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            for doc in ex.map(read_one, files):
                if doc is not None:
                    documents.append(doc)

    if images_dir:
        from .io.packed import is_packed_corpus

        p = Path(images_dir)
        if is_packed_corpus(p):
            # Pre-decoded corpus: every document's image is an mmap row
            # view — zero decode at signal time (see dewi.io.packed).
            from .io.packed import PackedImages

            pack = PackedImages(p)
            manifest = Path(str(p) + ".manifest.json")
            names = (
                json.loads(manifest.read_text())
                if manifest.exists() else None
            )
            for i in range(len(pack)):
                src = names[i] if names else f"{p}[{i}]"
                doc = create_document(
                    text=None, metadata={"source": src, "type": "image"}
                )
                doc.image = pack[i]
                documents.append(doc)
        else:
            image_files: List[Path] = []
            for pattern in IMAGE_GLOBS:
                image_files.extend(sorted(p.glob(pattern)))
            for img in image_files:
                doc = create_document(
                    text=None, metadata={"source": str(img), "type": "image"}
                )
                doc.image_path = str(img)
                documents.append(doc)

    if embeddings_path:
        import numpy as np

        try:
            data = np.load(embeddings_path, allow_pickle=True)
            if "embeddings" in data and "doc_ids" in data:
                for emb, doc_id in zip(data["embeddings"], data["doc_ids"]):
                    doc = create_document(
                        text=None,
                        metadata={"source": str(doc_id), "type": "embedding"},
                    )
                    doc.embedding = np.asarray(emb, dtype=np.float32)
                    documents.append(doc)
        except Exception as e:  # noqa: BLE001
            click.echo(
                f"Error loading embeddings from {embeddings_path}: {e}",
                err=True,
            )

    return documents


def _as_corpus(documents: Any, texts: Any, images: Any,
               embeddings: Any) -> Any:
    """Columnarize loaded documents for the array-native pipeline paths.

    Pure packed-image corpora hand the pipeline the mmap pack itself
    rather than per-doc row views — signal stages then slice the 4-D
    mapping directly (and the one-time device-resident upload applies)
    instead of copying rows through the decode cache.
    """
    from .corpus import Corpus
    from .io.packed import is_packed_corpus

    corpus = Corpus.from_documents(documents)
    if images and not texts and not embeddings and is_packed_corpus(images):
        import numpy as np

        from .io.packed import PackedImages

        pack = PackedImages(images)
        if len(pack) == len(corpus):
            corpus.images = pack
            corpus.has_image = np.ones(len(corpus), bool)
    return corpus


def _save_results(documents: Any, output_dir: Path,
                  batch_size: int = 1000) -> None:
    """Write batched JSONL + npz + summary + metadata with timestamped backup
    (artifact-layout parity: reference cli.py:459-661)."""
    import numpy as np

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if any(out.iterdir()):
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        backup = out.parent / f"{out.name}_backup_{ts}"
        shutil.copytree(out, backup)
        click.echo(f"Created backup of existing output at {backup}")

    if _test_mode() or documents is None:
        docs = [
            {
                "id": f"doc_{i}",
                "text": f"Test document {i} content.",
                "metadata": {"source": "test", "id": i, "type": "test"},
                "signals": {
                    "ht_mean": round(0.5 + i * 0.1, 4),
                    "hi_mean": round(0.4 + i * 0.05, 4),
                    "I_hat": round(0.3 + i * 0.02, 4),
                    "redundancy": round(0.1 + i * 0.01, 4),
                    "noise": round(0.05 + i * 0.005, 4),
                },
                "dewi_score": round(0.7 - i * 0.05, 4),
                "embedding": [round(0.1 * (i + 1), 4)] * 10,
            }
            for i in range(10)
        ]
        with open(out / "documents_batch_0001.jsonl", "w", encoding="utf-8") as f:
            for d in docs:
                f.write(json.dumps(d, ensure_ascii=False) + "\n")
        with open(out / "signals_summary.json", "w", encoding="utf-8") as f:
            json.dump(
                [{"id": d["id"], **d["signals"],
                  "dewi_score": d["dewi_score"]} for d in docs],
                f, indent=2,
            )
        np.savez_compressed(
            out / "embeddings.npz",
            embeddings=np.array([d["embedding"] for d in docs], np.float32),
            doc_ids=[d["id"] for d in docs],
        )
        (out / "index").mkdir(exist_ok=True)
        (out / "index" / "config.json").write_text(
            json.dumps({"test_mode": True, "dim": 10}), encoding="utf-8"
        )
        (out / "metadata.json").write_text(
            json.dumps(
                {
                    "version": "1.0.0",
                    "created_at": datetime.now().isoformat(),
                    "num_documents": len(docs),
                    "dimensions": 10,
                    "test_mode": True,
                },
                indent=2,
            ),
            encoding="utf-8",
        )
        return

    signals_summary: List[Dict[str, Any]] = []
    n_batches = (len(documents) + batch_size - 1) // batch_size
    for b in range(n_batches):
        batch = documents[b * batch_size : (b + 1) * batch_size]
        rows = []
        embs, ids = [], []
        for d in batch:
            sig = d.signals_dict()
            row = {
                "id": d.doc_id,
                "text": d.text,
                "metadata": getattr(d, "metadata", {}),
                "signals": sig,
                "dewi_score": d.dewi_score,
            }
            if d.embedding is not None:
                ids.append(d.doc_id)
                embs.append(np.asarray(d.embedding, np.float32))
            rows.append(row)
            signals_summary.append(
                {"id": d.doc_id, **sig, "dewi_score": d.dewi_score}
            )
        with open(out / f"documents_batch_{b + 1:04d}.jsonl", "w",
                  encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
        if embs:
            np.savez_compressed(
                out / f"embeddings_batch_{b + 1:04d}.npz",
                doc_ids=ids,
                embeddings=np.stack(embs),
            )
        click.echo(f"Processed batch {b + 1}/{n_batches} ({len(batch)} documents)")

    with open(out / "signals_summary.json", "w", encoding="utf-8") as f:
        json.dump(signals_summary, f, indent=2, ensure_ascii=False)
    dims = (
        len(documents[0].embedding)
        if documents and documents[0].embedding is not None
        else 0
    )
    (out / "metadata.json").write_text(
        json.dumps(
            {
                "version": "1.0.0",
                "created_at": datetime.now().isoformat(),
                "num_documents": len(documents),
                "dimensions": dims,
                "test_mode": False,
            },
            indent=2,
        ),
        encoding="utf-8",
    )


if __name__ == "__main__":
    cli()
