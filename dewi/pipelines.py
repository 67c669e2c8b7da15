"""Signal-computation pipeline: documents -> signals -> DEWI scores.

Capability parity with the reference pipeline (reference pipelines.py:18-237:
``Document``, ``DewiPipeline.compute_signals`` / ``compute_dewi_scores``,
``create_document``) with the §2.4 API mismatches resolved — every estimator
call here matches the estimator contracts in :mod:`dewi.signals`.

Differences from the reference:

* scoring is matrix-native — one fused fit+score XLA call over the whole
  corpus instead of the per-document Python loop (pipelines.py:217-221);
* estimators batch on device (bucketed text, padded image batches);
* documents missing embeddings get CLIP embeddings (text tower, image tower,
  or their mean), which also makes text queries searchable (§2.4 item 6);
* stage-level checkpoint/resume: each signal stage persists its outputs, so
  a restarted run skips completed stages (the reference restarts from
  scratch — SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import DewiConfig
from .types import SIGNAL_FIELDS, Payload, Weights

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]


@dataclass
class Document:
    """Per-document record (parity: reference pipelines.py:18-34, plus an
    in-memory ``image`` array field for hermetic array-native ingestion)."""

    doc_id: str
    text: Optional[str] = None
    image_path: Optional[str] = None
    image: Optional[np.ndarray] = None
    embedding: Optional[np.ndarray] = None

    ht_mean: Optional[float] = None
    ht_q90: Optional[float] = None
    hi_mean: Optional[float] = None
    hi_q90: Optional[float] = None
    I_hat: Optional[float] = None
    redundancy: Optional[float] = None
    noise: Optional[float] = None
    dewi_score: Optional[float] = None

    def signals_dict(self) -> Dict[str, float]:
        """None-coalescing signal view (parity: reference pipelines.py:199-210)."""
        return {k: float(getattr(self, k) or 0.0) for k in SIGNAL_FIELDS}

    def payload(self) -> Payload:
        return Payload(dewi=float(self.dewi_score or 0.0), **self.signals_dict())

    def image_source(self) -> Any:
        return self.image if self.image is not None else self.image_path


def create_document(
    doc_id: str,
    text: Optional[str] = None,
    image_path: Optional[PathLike] = None,
    embedding: Optional[np.ndarray] = None,
    image: Optional[np.ndarray] = None,
) -> Document:
    """Parity: reference pipelines.py:225-237."""
    return Document(
        doc_id=doc_id,
        text=text,
        image_path=str(image_path) if image_path else None,
        image=image,
        embedding=embedding,
    )


class _StageCheckpoint:
    """Per-stage npz checkpoints: ``<dir>/<stage>.npz`` + corpus digest.

    Besides the doc count, each checkpoint records a digest of the corpus
    identity (doc ids, text content, image file identity), so resuming against a *different*
    same-length corpus (edited docs, reordered ids) discards the stale cache
    instead of silently applying cached signals to the wrong documents
    (ADVICE.md round 1)."""

    def __init__(self, directory: Optional[PathLike],
                 documents: Any) -> None:
        self.dir = Path(directory) if directory else None
        if isinstance(documents, int):  # legacy: count only, no digest
            self.n_docs = documents
            self.digest = ""
        else:
            self.n_docs = len(documents)
            self.digest = self._digest(documents)
        if self.dir:
            self.dir.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _digest(documents: Any) -> str:
        import hashlib
        import os

        h = hashlib.sha256()
        for d in documents:
            h.update(d.doc_id.encode())
            # Text CONTENT, not just length: same-length edits must
            # invalidate the cache.
            h.update((d.text or "").encode("utf-8", "replace"))
            h.update(b"\0")
            # Image identity: path plus size/mtime when it is a real file
            # (re-exported images with the same name invalidate too).
            ip = getattr(d, "image_path", None)
            if ip:
                h.update(str(ip).encode())
                try:
                    st = os.stat(ip)
                    h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
                except OSError:
                    pass
            arr = getattr(d, "image", None)
            if arr is not None:
                # In-memory arrays: shape/dtype plus a strided byte sample
                # (hashing whole corpora of pixels would dominate resume).
                a = np.ascontiguousarray(arr)
                h.update(str((a.shape, str(a.dtype))).encode())
                flat = a.reshape(-1).view(np.uint8)
                h.update(flat[:: max(1, flat.size // 4096)].tobytes())
            h.update(b"\1")
        return h.hexdigest()[:16]

    def load(self, stage: str) -> Optional[Dict[str, np.ndarray]]:
        if not self.dir:
            return None
        path = self.dir / f"{stage}.npz"
        if not path.exists():
            return None
        data = np.load(path, allow_pickle=False)
        if int(data["n_docs"]) != self.n_docs:
            logger.warning("Checkpoint %s is for %d docs (have %d); ignoring.",
                           path, int(data["n_docs"]), self.n_docs)
            return None
        saved_digest = str(data["digest"]) if "digest" in data.files else ""
        if self.digest and saved_digest and saved_digest != self.digest:
            logger.warning(
                "Checkpoint %s was computed for a different corpus "
                "(digest %s != %s); ignoring.", path, saved_digest, self.digest
            )
            return None
        return {
            k: data[k] for k in data.files if k not in ("n_docs", "digest")
        }

    def save(self, stage: str, **arrays: np.ndarray) -> None:
        if not self.dir:
            return
        np.savez(self.dir / f"{stage}.npz", n_docs=self.n_docs,
                 digest=self.digest, **arrays)


class _CorpusImages:
    """Decode-once image cache for one ``compute_signals`` call.

    The reference decodes every image once per consuming stage — MAE, CLIP,
    blur/NSFW, (and now pHash), i.e. 3-4 full decode passes over the corpus
    (reference image_entropy.py:39-49, cross_modal.py:55-60, noise.py:47-63).
    Here the corpus is decoded ONCE at the largest resolution any stage
    needs (threaded, JPEG draft mode, uint8 — :mod:`dewi.io`) and every
    stage reads from RAM.  Corpora beyond ``runtime.decode_cache_mb`` fall
    back to the estimators' own streaming prefetch decoders.
    """

    def __init__(self, sources: Any, img_idx: Any, base_size: int,
                 threads: int, budget_mb: int) -> None:
        from .io.images import ImageCache

        self.pos = {i: j for j, i in enumerate(img_idx)}
        self.sources = list(sources)  # aligned with img_idx
        self.cache = None
        if self.sources and ImageCache.fits(
            len(self.sources), base_size, budget_mb
        ):
            try:
                self.cache = ImageCache(
                    self.sources, base_size, threads=threads
                )
            except Exception as e:  # noqa: BLE001 — fall back to streaming
                logger.warning("Image decode cache unavailable (%s); "
                               "stages will decode independently.", e)

    def rows(self, idx_list: Any, size: int) -> Any:
        """Images for ``idx_list`` at ``size``: a ``[n, size, size, 3]``
        uint8 array when cached, else the original sources (streamed)."""
        if self.cache is None:
            return [self.sources[self.pos[i]] for i in idx_list]
        if size <= self.cache.base_size:
            arr = self.cache.at(size)
        else:  # stage wants more pixels than the cache holds: serve base
            logger.warning(
                "Image cache holds %dpx but a stage requested %dpx; serving "
                "the %dpx cache (the model will upscale). Raise the cache "
                "base size if this stage's fidelity matters.",
                self.cache.base_size, size, self.cache.base_size,
            )
            arr = self.cache.base
        rows = [self.pos[i] for i in idx_list]
        if rows == list(range(len(arr))):
            return arr
        return arr[np.asarray(rows, np.int64)]

    def source(self, i: int) -> Any:
        """Single image for host-side per-doc loops (noise heuristics)."""
        if self.cache is None:
            return self.sources[self.pos[i]]
        return self.cache.base[self.pos[i]]


class DewiPipeline:
    """Signals + scoring orchestration (parity: reference pipelines.py:36-223)."""

    def __init__(self, config: Optional[DewiConfig] = None,
                 nsfw_fn: Any = None, mesh: Any = None) -> None:
        """``mesh`` (or ``config.mesh.data_parallel_signals: true``) runs
        every estimator forward DATA-PARALLEL over the device mesh: model
        params replicate, signal batches shard over the ``data`` axis
        (parallel/signals.py) — the corpus-processing scale-out the
        reference's single-GPU loops cannot do (reference
        pipelines.py:87-160)."""
        self.config = config or DewiConfig()
        self.mesh = mesh
        if self.mesh is None and self.config.mesh.data_parallel_signals:
            from .parallel.mesh import make_mesh

            m = self.config.mesh
            self.mesh = make_mesh(
                n_data=m.data if m.data > 0 else None,
                n_model=max(1, int(m.model)),
            )
        self._nsfw_fn = nsfw_fn
        self._text_entropy = None
        self._image_entropy = None
        self._cross_modal = None
        self._redundancy = None
        self._noise = None
        # Doc ids whose embeddings THIS pipeline filled via the CLIP towers
        # (vs supplied externally) — decides the provenance an index records.
        self._clip_embedded_ids: set = set()

    # -- lazy estimators (constructed on first use; ctor stays cheap) --------

    @property
    def text_entropy(self) -> Any:
        if self._text_entropy is None:
            from .signals.text_entropy import TextEntropyEstimator

            c = self.config.text
            self._text_entropy = TextEntropyEstimator(
                model_name=c.model,
                quantiles=c.quantiles,
                batch_size=c.batch_size,
                max_length=c.max_length,
                tokenizer=c.tokenizer,
                domain_model_name=c.domain_model,
                checkpoint=c.checkpoint,
                domain_checkpoint=c.domain_checkpoint,
                seed=c.seed,
                mesh=self.mesh,
            )
        return self._text_entropy

    @property
    def image_entropy(self) -> Any:
        if self._image_entropy is None:
            from .signals.image_entropy import ImageEntropyEstimator

            c = self.config.image
            self._image_entropy = ImageEntropyEstimator(
                model_name=c.model,
                patch_size=c.patch_size,
                image_size=c.image_size,
                mask_ratio=c.mask_ratio,
                batch_size=c.batch_size,
                checkpoint=c.checkpoint,
                seed=c.seed,
                io_threads=self.config.runtime.io_threads,
                mesh=self.mesh,
            )
        return self._image_entropy

    @property
    def cross_modal(self) -> Any:
        if self._cross_modal is None:
            from .signals.cross_modal import CrossModalDependency

            c = self.config.cross_modal
            self._cross_modal = CrossModalDependency(
                model_name=c.model,
                batch_size=c.batch_size,
                tokenizer=self.config.text.tokenizer,
                checkpoint=c.checkpoint,
                seed=c.seed,
                io_threads=self.config.runtime.io_threads,
                image_size=getattr(c, "image_size", None),
                mesh=self.mesh,
            )
        return self._cross_modal

    @property
    def redundancy(self) -> Any:
        if self._redundancy is None:
            from .signals.redundancy import RedundancyEstimator

            c = self.config.redundancy
            self._redundancy = RedundancyEstimator(
                model_name=self.config.cross_modal.model,
                text_sim=c.text_sim,
                image_sim=c.image_sim,
                cross_modal_density=c.cross_modal_density,
                block_size=c.block_size,
                threshold=c.threshold,
                clip=self._cross_modal,  # share towers when already built
                mesh=self.mesh,
            )
        return self._redundancy

    @property
    def noise(self) -> Any:
        if self._noise is None:
            from .signals.noise import NoiseEstimator

            c = self.config.noise
            self._noise = NoiseEstimator(
                expected_language=c.expected_language,
                blur_threshold=c.blur_threshold,
                ocr_min_coverage=c.ocr_min_coverage,
                nsfw_filter=c.nsfw_filter,
                nsfw_fn=self._nsfw_fn,
            )
        return self._noise

    # -- signals --------------------------------------------------------------

    def compute_signals(
        self,
        documents: List[Document],
        progress: bool = False,
        checkpoint_dir: Optional[PathLike] = None,
        include_redundancy: bool = True,
    ) -> List[Document]:
        """Fill the seven signal fields of every document, stage by stage.

        ``include_redundancy=False`` defers the (cross-document) redundancy
        stage — used by :meth:`process_stream`, which runs it globally after
        all shards so sharding never changes scores.
        """
        if not documents:
            return []
        ckpt = _StageCheckpoint(checkpoint_dir, documents)

        def log_stage(name: str) -> None:
            if progress:
                print(f"Computing {name}...")

        def meter(name: str, total: int) -> "ProgressMeter":
            # Per-batch docs/s + ETA inside multi-minute stages (the
            # reference's tqdm UX, pipelines.py:107-147) — throttled, so
            # corpus-scale runs show liveness without per-doc print cost.
            from .utils.progress import ProgressMeter

            return ProgressMeter(total, name, enabled=bool(progress))

        # Stage 1: text entropy (bucketed LM batches).
        text_idx = [i for i, d in enumerate(documents) if d.text]
        if text_idx:
            cached = ckpt.load("text")
            if cached is None:
                log_stage("text entropy")
                m = meter("text entropy", len(text_idx))
                # Stats-only path: aggregates come straight off device, no
                # per-token host materialization (the corpus-scale win).
                means, q90s, _ = self.text_entropy.batch_compute_stats(
                    [documents[i].text for i in text_idx],
                    progress=m.update,
                )
                m.close()
                ckpt.save("text", idx=np.array(text_idx), means=means, q90s=q90s)
            else:
                means, q90s = cached["means"], cached["q90s"]
            for j, i in enumerate(text_idx):
                documents[i].ht_mean = float(means[j])
                documents[i].ht_q90 = float(q90s[j])

        # Stage 2: image entropy (padded MAE batches, per-patch quantiles).
        img_idx = [
            i for i, d in enumerate(documents) if d.image_source() is not None
        ]
        images = self._decode_images(documents, img_idx) if img_idx else None
        if img_idx:
            cached = ckpt.load("image")
            if cached is None:
                log_stage("image entropy")
                m = meter("image entropy", len(img_idx))
                means, q90s = self.image_entropy.batch_compute_stats(
                    images.rows(img_idx, self.image_entropy.image_size),
                    progress=m.update,
                )
                m.close()
                ckpt.save("image", idx=np.array(img_idx), means=means, q90s=q90s)
            else:
                means, q90s = cached["means"], cached["q90s"]
            for j, i in enumerate(img_idx):
                documents[i].hi_mean = float(means[j])
                documents[i].hi_q90 = float(q90s[j])

        # Stage 3: cross-modal dependency (CLIP diagonal).
        pair_idx = [
            i for i, d in enumerate(documents)
            if d.text and d.image_source() is not None
        ]
        if pair_idx:
            cached = ckpt.load("cross_modal")
            if cached is None:
                log_stage("cross-modal dependency")
                m = meter("cross-modal", len(pair_idx))
                results = self.cross_modal.batch_compute(
                    [documents[i].text for i in pair_idx],
                    images.rows(pair_idx, self.cross_modal.cfg.image_size),
                    progress=m.update,
                )
                m.close()
                sims = np.array([r.info_nce_score for r in results], np.float32)
                ckpt.save("cross_modal", idx=np.array(pair_idx), sims=sims)
            else:
                sims = cached["sims"]
            for j, i in enumerate(pair_idx):
                documents[i].I_hat = float(sims[j])

        # Stage 4: embeddings for docs missing them (CLIP towers) —
        # prerequisite for redundancy and for indexing (§2.4 item 6).
        self.ensure_embeddings(documents, images=images)

        # Stage 5: redundancy (embedding-space max-offdiag, or hash mode;
        # cross-document, so process_stream defers it to a global pass).
        if include_redundancy:
            log_stage("redundancy")
            self._redundancy_stage(documents, ckpt, images=images)

        return self._noise_stage(documents, ckpt, log_stage, images=images,
                                 progress=bool(progress))

    def _decode_images(
        self, documents: List[Document], img_idx: List[int]
    ) -> _CorpusImages:
        """Decode every image document once for all downstream stages."""
        return self._decode_sources(
            [documents[i].image_source() for i in img_idx], img_idx
        )

    def _decode_sources(self, sources: Any,
                        img_idx: Any) -> _CorpusImages:
        sizes = [self._mae_image_size(), self._clip_image_size()]
        rt = self.config.runtime
        return _CorpusImages(
            sources, img_idx, base_size=max(sizes),
            threads=rt.io_threads, budget_mb=rt.decode_cache_mb,
        )

    def _mae_image_size(self) -> int:
        if self._image_entropy is not None:
            return self._image_entropy.image_size
        c = self.config.image
        side = self._sidecar_size(c.checkpoint)
        if side:
            return side
        if c.image_size:
            return int(c.image_size)
        if c.model in ("pixel", "none", "proxy"):
            return 224
        from .models.registry import mae_config

        return mae_config(c.model).image_size

    def _clip_image_size(self) -> int:
        if self._cross_modal is not None:
            return self._cross_modal.cfg.image_size
        side = self._sidecar_size(self.config.cross_modal.checkpoint)
        if side:
            return side
        over = getattr(self.config.cross_modal, "image_size", None)
        if over:
            return int(over)
        from .models.registry import clip_config

        return clip_config(self.config.cross_modal.model).image_size

    @staticmethod
    def _sidecar_size(checkpoint: Any) -> Optional[int]:
        """image_size from a checkpoint's architecture sidecar, if any."""
        if not checkpoint:
            return None
        from .models.import_hf import sidecar_config

        side = sidecar_config(checkpoint)
        if side and side.get("config", {}).get("image_size"):
            return int(side["config"]["image_size"])
        return None

    def _noise_stage(self, documents: List[Document], ckpt: Any,
                     log_stage: Any, images: Any = None,
                     progress: bool = False) -> List[Document]:
        """Stage 6: noise (host-side heuristics)."""
        cached = ckpt.load("noise")
        if cached is None:
            log_stage("noise")
            from .signals.noise import BLUR_SIZE

            # The blur detector needs >= BLUR_SIZE pixels of fidelity; a
            # smaller cache would shift its verdict, so fall back to the
            # original sources in that (tiny-model) case.
            if (
                images is not None
                and images.cache is not None
                and images.cache.base_size >= BLUR_SIZE
            ):
                img_list = [
                    images.source(i) if d.image_source() is not None else None
                    for i, d in enumerate(documents)
                ]
            else:
                img_list = [d.image_source() for d in documents]
            from .utils.progress import ProgressMeter

            m = ProgressMeter(len(documents), "noise", enabled=progress)
            noise = np.array(
                self.noise.batch_compute(
                    texts=[d.text for d in documents],
                    images=img_list,
                    progress=m.update,
                ),
                np.float32,
            )
            m.close()
            ckpt.save("noise", scores=noise)
        else:
            noise = cached["scores"]
        for i, d in enumerate(documents):
            d.noise = float(noise[i])
        return documents

    def _redundancy_stage(
        self, documents: List[Document], ckpt: "_StageCheckpoint",
        images: Optional[_CorpusImages] = None,
    ) -> List[Document]:
        """Global redundancy over an already-embedded document list.

        Modes (config.redundancy): ``text_sim: minhash|simhash`` hashes text
        docs; ``image_sim: phash`` perceptual-hashes image docs; anything
        else scores docs by embedding-space max-offdiag similarity.  When
        hash modes cover only one modality, the remaining docs fall back to
        the embedding mode, and a doc covered by several modes keeps its max.
        """
        cached = ckpt.load("redundancy")
        if cached is None:
            scores = np.zeros(len(documents), np.float32)
            hash_covered: set = set()
            text_hash = self.config.redundancy.text_sim in ("minhash", "simhash")
            image_hash = self.config.redundancy.image_sim == "phash"
            if text_hash:
                text_idx = [i for i, d in enumerate(documents) if d.text]
                if text_idx:
                    scores[np.array(text_idx)] = self.redundancy.score_texts(
                        [documents[i].text for i in text_idx]
                    )
                hash_covered.update(text_idx)
            if image_hash:
                img_idx = [
                    i for i, d in enumerate(documents)
                    if d.image_source() is not None
                ]
                if img_idx:
                    srcs = (
                        images.rows(img_idx, 32)  # pHash's DCT resolution
                        if images is not None
                        else [documents[i].image_source() for i in img_idx]
                    )
                    ph = self.redundancy.score_images(srcs)
                    scores[np.array(img_idx)] = np.maximum(
                        scores[np.array(img_idx)], ph
                    )
                hash_covered.update(img_idx)
            rest = (
                [i for i in range(len(documents)) if i not in hash_covered]
                if (text_hash or image_hash)
                else list(range(len(documents)))
            )
            by_dim: Dict[int, List[int]] = {}
            for i in rest:
                by_dim.setdefault(len(documents[i].embedding), []).append(i)
            for idxs in by_dim.values():
                if len(idxs) < 2:
                    continue
                emb = np.stack([documents[i].embedding for i in idxs])
                scores[np.array(idxs)] = np.maximum(
                    scores[np.array(idxs)], self.redundancy.score(emb)
                )
            # Cross-modal density (config.redundancy.cross_modal_density):
            # multimodal docs carry a JOINT text+image embedding
            # (ensure_embeddings) — score their neighborhood density in that
            # joint space and keep the max.  Catches caption+image near-dups
            # the lexical/perceptual hash modes see as distinct.
            if self.redundancy.cross_modal_density:
                both = [
                    i for i, d in enumerate(documents)
                    if d.text and d.image_source() is not None
                    and d.embedding is not None
                ]
                if len(both) >= 2:
                    emb = np.stack([documents[i].embedding for i in both])
                    dens = self.redundancy.cross_modal_density_scores(emb)
                    scores[np.array(both)] = np.maximum(
                        scores[np.array(both)], dens
                    )
            ckpt.save("redundancy", scores=np.asarray(scores, np.float32))
        else:
            scores = cached["scores"]
        for i, d in enumerate(documents):
            d.redundancy = float(scores[i])
        return documents

    def ensure_embeddings(
        self, documents: List[Document],
        images: Optional[_CorpusImages] = None,
    ) -> List[Document]:
        """Fill missing ``embedding`` fields from the CLIP towers.

        Text-only docs get text-tower embeddings, image-only docs image-tower
        embeddings, multimodal docs the normalized mean of both.  All towers
        emit unit-norm vectors in the same space, so the index can mix them.
        """
        missing = [i for i, d in enumerate(documents) if d.embedding is None]
        self._clip_embedded_ids.update(documents[i].doc_id for i in missing)
        if not missing:
            return documents
        t_idx = [i for i in missing if documents[i].text]
        v_idx = [
            i for i in missing if documents[i].image_source() is not None
        ]
        t_emb = (
            self.cross_modal.encode_texts([documents[i].text for i in t_idx])
            if t_idx else None
        )
        v_emb = (
            self.cross_modal.encode_images(
                images.rows(v_idx, self.cross_modal.cfg.image_size)
                if images is not None
                else [documents[i].image_source() for i in v_idx]
            )
            if v_idx else None
        )
        dim = self.cross_modal.cfg.d_embed
        tmap = {i: t_emb[j] for j, i in enumerate(t_idx)} if t_idx else {}
        vmap = {i: v_emb[j] for j, i in enumerate(v_idx)} if v_idx else {}
        for i in missing:
            parts = [m[i] for m in (tmap, vmap) if i in m]
            if not parts:
                documents[i].embedding = np.zeros(dim, np.float32)
                continue
            e = np.mean(parts, axis=0)
            n = np.linalg.norm(e)
            documents[i].embedding = (e / n if n > 0 else e).astype(np.float32)
        return documents

    def encode_query(self, text: str) -> np.ndarray:
        """Text -> embedding for search (resolves SURVEY.md §2.4 item 6)."""
        return self.cross_modal.encode_texts([text])[0]

    def encoder_provenance(self) -> Dict[str, object]:
        """Identity of the embedding encoder (CLIP towers) for this pipeline.

        Recorded into any index built from these embeddings so search/eval
        can reconstruct the SAME query encoder (preset + tokenizer + seed +
        checkpoint) instead of guessing by embedding dim — a mismatched
        encoder silently returns meaningless rankings (ADVICE.md round 1).
        """
        from .models.registry import checkpoint_fingerprint

        c = self.config.cross_modal
        return {
            "model": c.model,
            "tokenizer": self.config.text.tokenizer,
            "seed": int(c.seed),
            "checkpoint": c.checkpoint,
            "checkpoint_fingerprint": checkpoint_fingerprint(c.checkpoint),
            "d_embed": int(self.cross_modal.cfg.d_embed)
            if self._cross_modal is not None
            else None,
        }

    # -- scoring ----------------------------------------------------------------

    def compute_dewi_scores(
        self,
        documents: List[Document],
        weights: Optional[Union[Dict[str, float], Weights]] = None,
        delta: Optional[float] = None,
        mode: Optional[str] = None,
    ) -> List[Document]:
        """Fit robust stats + score all docs in one fused XLA call
        (parity: reference pipelines.py:162-223, minus the per-doc loop)."""
        if not documents:
            return []
        scorer = self._make_scorer(weights, delta)
        scoring_mode = mode or self.config.scoring.mode

        mat = np.array(
            [[d.signals_dict()[k] for k in SIGNAL_FIELDS] for d in documents],
            np.float32,
        )
        scores = np.asarray(scorer.fit_and_score(mat, mode=scoring_mode))
        for d, s in zip(documents, scores):
            d.dewi_score = float(s)
        self._scorer = scorer  # fitted stats, reusable for incremental docs
        return documents

    def process_stream(
        self,
        documents: List[Document],
        shard_size: Optional[int] = None,
        checkpoint_dir: Optional[PathLike] = None,
        weights: Any = None,
        delta: Optional[float] = None,
        mode: Optional[str] = None,
        progress: bool = False,
    ) -> List[Document]:
        """Sharded signal computation with per-shard resume + global scoring.

        Corpora larger than memory/HBM process in ``shard_size`` chunks;
        each shard's signal stages checkpoint independently (a restarted run
        skips completed shards), and robust statistics are fit GLOBALLY over
        all shards before scoring — identical results to the monolithic path
        (the reference restarts signal computation from scratch on any
        failure — SURVEY.md §5 checkpoint/resume).
        """
        if not documents:
            return []
        shard_size = int(shard_size or self.config.runtime.shard_size)
        ckpt_root = Path(checkpoint_dir) if checkpoint_dir else None
        n_shards = (len(documents) + shard_size - 1) // shard_size
        for s in range(n_shards):
            shard = documents[s * shard_size : (s + 1) * shard_size]
            sub = ckpt_root / f"shard_{s:05d}" if ckpt_root else None
            if progress:
                print(f"Shard {s + 1}/{n_shards} ({len(shard)} docs)")
            self.compute_signals(shard, progress=progress, checkpoint_dir=sub,
                                 include_redundancy=False)
        # Redundancy is cross-document: run it globally over all shards so
        # sharding never changes scores.
        self._redundancy_stage(
            documents, _StageCheckpoint(ckpt_root, documents)
        )
        # Global fit+score across every shard in one fused call.
        return self.compute_dewi_scores(documents, weights=weights,
                                        delta=delta, mode=mode)

    def _make_scorer(self, weights: Any = None,
                     delta: Optional[float] = None) -> Any:
        from .scorer import DewiScorer

        if weights is None:
            w = self.config.scoring.weights
            weights = Weights(
                alpha_t=w.alpha_t, alpha_i=w.alpha_i, alpha_m=w.alpha_m,
                alpha_r=w.alpha_r, alpha_n=w.alpha_n,
            )
        elif isinstance(weights, dict):
            weights = Weights(**weights)
        return DewiScorer(
            weights=weights, delta=delta or self.config.scoring.delta
        )

    # -- columnar fast path -------------------------------------------------------
    #
    # Same stages and numerics as compute_signals/compute_dewi_scores, but
    # over a Corpus column store — no per-Document attribute traffic, no
    # per-doc dict/stack in the hot loop, so host bookkeeping does not
    # outweigh the device forwards.

    def _corpus_rows(self, corpus: Any, idx: Any, size: int,
                     cache: Any = None, dev: Any = None) -> Any:
        """Image batch for corpus rows ``idx`` at ``size`` (or source list).

        ``dev`` is an optional ``(DeviceImages, pos_map_or_None)`` pair: when
        set, the batch is served as device-resident rows (a DeviceImages
        view — ``iter_corpus_batches`` slices/resizes it in HBM with zero
        host decode or re-upload).  Only pass ``dev`` to consumers that
        stream through ``iter_corpus_batches``.
        """
        imgs = corpus.images
        idx = np.asarray(idx, np.int64)
        if dev is not None:
            di, pos = dev
            rows = (
                idx if pos is None
                else np.asarray([pos[int(i)] for i in idx], np.int64)
            )
            if rows.size == len(di) and np.array_equal(
                rows, np.arange(len(di))
            ):
                return di
            return di.gather(rows)
        if hasattr(imgs, "rows"):  # PackedImages: mmap slice (+downscale)
            return imgs.rows(idx, size)
        if isinstance(imgs, np.ndarray):  # dense pre-decoded corpus
            if idx.size == len(imgs) and np.array_equal(
                idx, np.arange(len(imgs))
            ):
                return imgs
            return imgs[idx]
        if cache is not None:
            return cache.rows(list(idx), size)
        return [imgs[i] for i in idx]

    def _device_corpus(self, corpus: Any, cache: Any = None) -> Any:
        """``(DeviceImages, pos_map_or_None)`` for this corpus, or ``None``.

        Uploads a uniform uint8 image corpus to device memory ONCE so the
        MAE tower, the CLIP vision tower, and the blur/skin noise kernel all
        read device memory instead of each re-uploading the same bytes (3x
        the corpus over PCIe otherwise).  Sources, in order of
        preference: a dense ``[N, H, W, 3]`` corpus array, a PackedImages
        mmap (one sequential read), or the decode-once cache.  Gated on the
        ``DEWI_DEVICE_IMAGES_MAX_BYTES`` budget — over-budget corpora keep
        the host paths unchanged (io/device_images.py).
        """
        from .io.device_images import device_images_or_none

        if self.mesh is not None and self.mesh.devices.size > 1:
            # Device residency pins the corpus to ONE device; under a
            # data-parallel mesh the host batch paths shard each batch over
            # all devices instead (sharded DeviceImages is future work).
            return None
        imgs = corpus.images
        src, pos = None, None
        if isinstance(imgs, np.ndarray) and imgs.ndim == 4:
            src = imgs
        elif hasattr(imgs, "data") and isinstance(
            getattr(imgs, "data", None), np.ndarray
        ):
            src = imgs.data  # PackedImages: materialise the mmap once
        elif cache is not None and cache.cache is not None:
            src = cache.cache.base
            pos = cache.pos  # cache rows are img_idx-aligned, not doc-aligned
        di = device_images_or_none(src) if src is not None else None
        return (di, pos) if di is not None else None

    def compute_signals_corpus(self, corpus: Any, progress: bool = False,
                               include_redundancy: bool = True) -> Any:
        """Fill ``corpus.signals`` (all 7 columns) stage by stage.

        ``include_redundancy=False`` skips the cross-document redundancy
        stage — :meth:`process_stream_corpus` runs it globally after all
        shards so sharding never changes scores (same contract as the
        object path's ``process_stream``).
        """
        from .corpus import COL
        from .utils.progress import ProgressMeter

        n = len(corpus)
        if n == 0:
            return corpus
        sig = corpus.signals
        tidx = np.nonzero(corpus.has_text)[0]
        iidx = np.nonzero(corpus.has_image)[0]
        # Start the one-time device-resident image upload FIRST:
        # jax.device_put is async, so the corpus streams to HBM while the
        # text-entropy LM runs — the transfer hides behind stage 1 instead
        # of serializing ahead of stage 2.  (Per-doc sources can't pre-put:
        # they decode below, after which _device_corpus retries from cache.)
        dev = (
            self._device_corpus(corpus)
            if iidx.size and (
                hasattr(corpus.images, "rows")
                or isinstance(corpus.images, np.ndarray)
            ) else None
        )
        if tidx.size:
            m = ProgressMeter(int(tidx.size), "text entropy",
                              enabled=progress)
            means, q90s, _ = self.text_entropy.batch_compute_stats(
                [corpus.texts[i] for i in tidx], progress=m.update
            )
            m.close()
            sig[tidx, COL["ht_mean"]] = means
            sig[tidx, COL["ht_q90"]] = q90s

        cache = None
        if iidx.size and not (
            hasattr(corpus.images, "rows")
            or isinstance(corpus.images, np.ndarray)
        ):
            # Per-doc sources (paths/PIL): decode once for every stage.
            cache = self._decode_sources(
                [corpus.images[i] for i in iidx], list(iidx)
            )
        if dev is None and iidx.size:
            dev = self._device_corpus(corpus, cache)
        if iidx.size:
            m = ProgressMeter(int(iidx.size), "image entropy",
                              enabled=progress)
            means, q90s = self.image_entropy.batch_compute_stats(
                self._corpus_rows(corpus, iidx,
                                  self.image_entropy.image_size, cache,
                                  dev=dev),
                progress=m.update,
            )
            m.close()
            sig[iidx, COL["hi_mean"]] = means
            sig[iidx, COL["hi_q90"]] = q90s

        # Stages 3+4 share the CLIP towers: each tower encodes its modality
        # ONCE, the I_hat diagonal and the joint document embeddings both
        # read from the same arrays.  (The object path encodes twice —
        # batch_compute then ensure_embeddings — which doubles the dominant
        # cost of image-bearing corpora: tower forwards + host->device
        # image transfer.)
        pidx = np.nonzero(corpus.has_text & corpus.has_image)[0]
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        need_emb = corpus.embeddings is None or (
            ext_mask is not None and not bool(ext_mask.all())
        )
        t_emb = v_emb = None
        tpos: Dict[int, int] = {}
        vpos: Dict[int, int] = {}
        if need_emb or pidx.size:
            # Encode exactly what downstream needs: the paired docs (for
            # I_hat) plus — when embeddings must be filled — the rows NOT
            # covered by an external mask.  Encoding all of tidx/iidx with
            # a 90%-external corpus would throw away 90% of the dominant
            # stage cost (tower forwards + image transfer).
            if not need_emb:
                t_want = v_want = pidx
            elif ext_mask is not None:
                fill = ~ext_mask
                t_want = np.union1d(pidx, tidx[fill[tidx]]).astype(np.int64)
                v_want = np.union1d(pidx, iidx[fill[iidx]]).astype(np.int64)
            else:
                t_want, v_want = tidx, iidx
            if t_want.size:
                t_emb = self.cross_modal.encode_texts(
                    [corpus.texts[i] for i in t_want]
                )
                tpos = {int(i): j for j, i in enumerate(t_want)}
            if v_want.size:
                m = ProgressMeter(int(v_want.size), "cross-modal encode",
                                  enabled=progress)
                v_emb = self.cross_modal.encode_images(
                    self._corpus_rows(corpus, v_want,
                                      self.cross_modal.cfg.image_size,
                                      cache, dev=dev),
                    progress=m.update,
                )
                m.close()
                vpos = {int(i): j for j, i in enumerate(v_want)}
        if pidx.size:
            trows = np.asarray([tpos[int(i)] for i in pidx])
            vrows = np.asarray([vpos[int(i)] for i in pidx])
            sig[pidx, COL["I_hat"]] = np.sum(
                t_emb[trows] * v_emb[vrows], axis=1
            )

        self.ensure_embeddings_corpus(
            corpus, cache=cache, dev=dev,
            _t_emb=t_emb if need_emb else None,
            _v_emb=v_emb if need_emb else None,
            _t_idx=t_want if need_emb else None,
            _v_idx=v_want if need_emb else None,
        )
        if include_redundancy:
            self._redundancy_corpus(corpus, cache=cache)
        return self._noise_corpus(corpus, cache=cache, dev=dev,
                                  progress=progress)

    def ensure_embeddings_corpus(self, corpus: Any, cache: Any = None,
                                 dev: Any = None,
                                 _t_emb: Any = None, _v_emb: Any = None,
                                 _t_idx: Any = None,
                                 _v_idx: Any = None) -> Any:
        """Fill ``corpus.embeddings`` from the CLIP towers (vectorized
        combine; same semantics as :meth:`ensure_embeddings`).

        ``_t_emb``/``_v_emb`` (with their doc-index vectors ``_t_idx``/
        ``_v_idx``) let :meth:`compute_signals_corpus` pass the tower
        outputs it already computed for the cross-modal stage — no
        re-encode as long as they cover the rows being filled.

        Partial external embeddings (``corpus.ext_embedding_mask``) keep
        their supplied rows; only the unmasked rows are CLIP-filled —
        mirroring the object path's per-doc ``ensure_embeddings``.
        """
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        filled = getattr(corpus, "clip_filled_mask", None)
        if corpus.embeddings is not None and (
            ext_mask is None or bool(ext_mask.all())
            # Every non-external row already CLIP-filled (e.g. by
            # process_stream_corpus): re-encoding the towers over the
            # whole corpus here would redo the dominant cost monolithic.
            or (filled is not None and bool((ext_mask | filled).all()))
        ):
            if not hasattr(corpus, "clip_embedded"):
                corpus.clip_embedded = False  # supplied externally
            return corpus
        n = len(corpus)
        dim = self.cross_modal.cfg.d_embed
        ext = corpus.embeddings
        if ext is not None and ext.shape[1] != dim:
            raise ValueError(
                f"external embeddings are dim {ext.shape[1]} but the CLIP "
                f"towers emit dim {dim}; cannot fill the "
                f"{int((~ext_mask).sum())} docs without embeddings in the "
                "same index space — supply embeddings for every doc or "
                "match cross_modal.d_embed"
            )
        emb = np.zeros((n, dim), np.float32)
        cnt = np.zeros(n, np.float32)
        # Only rows actually being CLIP-filled need tower outputs — with a
        # partial external mask that's the unmasked rows, not the corpus.
        fill = np.ones(n, bool) if ext_mask is None else ~ext_mask

        def rows_from(done_emb: Any, done_idx: Any, want: Any) -> Any:
            """Reuse tower outputs for ``want`` rows when the caller's
            encode set covers them; encode just ``want`` otherwise."""
            if done_emb is not None and done_idx is not None:
                pos = {int(i): j for j, i in enumerate(done_idx)}
                if all(int(i) in pos for i in want):
                    return done_emb[[pos[int(i)] for i in want]]
            return None

        tidx = np.nonzero(corpus.has_text & fill)[0]
        if tidx.size:
            t_emb = rows_from(_t_emb, _t_idx, tidx)
            if t_emb is None:
                t_emb = self.cross_modal.encode_texts(
                    [corpus.texts[i] for i in tidx]
                )
            emb[tidx] += t_emb
            cnt[tidx] += 1
        iidx = np.nonzero(corpus.has_image & fill)[0]
        if iidx.size:
            v_emb = rows_from(_v_emb, _v_idx, iidx)
            if v_emb is None:
                v_emb = self.cross_modal.encode_images(
                    self._corpus_rows(corpus, iidx,
                                      self.cross_modal.cfg.image_size,
                                      cache, dev=dev)
                )
            emb[iidx] += v_emb
            cnt[iidx] += 1
        nz = cnt > 0
        emb[nz] /= cnt[nz, None]
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        np.divide(emb, norms, out=emb, where=norms > 0)
        if ext is not None:
            # Externally supplied rows win; CLIP fills only the gaps.
            emb = np.where(ext_mask[:, None], np.asarray(ext, np.float32),
                           emb)
            corpus.clip_filled_mask = ~ext_mask
            corpus.clip_embedded = False
        else:
            corpus.clip_filled_mask = np.ones(n, bool)
            corpus.clip_embedded = True
        corpus.embeddings = emb
        return corpus

    def _redundancy_corpus(self, corpus: Any, cache: Any = None) -> Any:
        from .corpus import COL

        n = len(corpus)
        scores = np.zeros(n, np.float32)
        covered = np.zeros(n, bool)
        text_hash = self.config.redundancy.text_sim in ("minhash", "simhash")
        image_hash = self.config.redundancy.image_sim == "phash"
        tidx = np.nonzero(corpus.has_text)[0]
        iidx = np.nonzero(corpus.has_image)[0]
        if text_hash and tidx.size:
            scores[tidx] = self.redundancy.score_texts(
                [corpus.texts[i] for i in tidx]
            )
            covered[tidx] = True
        if image_hash and iidx.size:
            rows = self._corpus_rows(corpus, iidx, 32, cache)  # pHash DCT res
            scores[iidx] = np.maximum(
                scores[iidx], self.redundancy.score_images(rows)
            )
            covered[iidx] = True
        rest = np.nonzero(~covered)[0]
        if rest.size >= 2 and corpus.embeddings is not None:
            scores[rest] = np.maximum(
                scores[rest], self.redundancy.score(corpus.embeddings[rest])
            )
        if self.redundancy.cross_modal_density:
            both = np.nonzero(corpus.has_text & corpus.has_image)[0]
            if both.size >= 2 and corpus.embeddings is not None:
                scores[both] = np.maximum(
                    scores[both],
                    self.redundancy.cross_modal_density_scores(
                        corpus.embeddings[both]
                    ),
                )
        corpus.signals[:, COL["redundancy"]] = scores
        return corpus

    def _noise_corpus(self, corpus: Any, cache: Any = None,
                      dev: Any = None, progress: bool = False) -> Any:
        from .corpus import COL
        from .signals.noise import BLUR_SIZE
        from .utils.progress import ProgressMeter

        n = len(corpus)
        texts = corpus.texts if corpus.texts is not None else [None] * n
        # Doc-aligned device corpus within the blur kernel's fidelity window:
        # run blur+skin straight off HBM (zero transfer), present-masked.
        if (
            dev is not None and dev[1] is None and len(dev[0]) == n
            and dev[0].size <= BLUR_SIZE and dev[0].shape[2] <= BLUR_SIZE
        ):
            imgs4 = dev[0].base
        elif (
            isinstance(corpus.images, np.ndarray)
            and corpus.images.ndim == 4 and len(corpus.images) == n
        ):
            # Dense host corpus: the masked array path batches eligible
            # shapes and degrades to the per-doc loop internally otherwise.
            imgs4 = corpus.images
        else:
            imgs4 = None
        if imgs4 is not None:
            m = ProgressMeter(n, "noise", enabled=progress)
            corpus.signals[:, COL["noise"]] = self.noise.batch_compute(
                texts=texts, images=imgs4,
                present=corpus.has_image, progress=m.update,
            )
            m.close()
            return corpus
        if cache is not None and cache.cache is not None and \
                cache.cache.base_size >= BLUR_SIZE:
            img_list = [
                cache.source(i) if corpus.has_image[i] else None
                for i in range(n)
            ]
        elif corpus.images is None:
            img_list = [None] * n
        else:
            img_list = [
                corpus.images[i] if corpus.has_image[i] else None
                for i in range(n)
            ]
        m = ProgressMeter(n, "noise", enabled=progress)
        corpus.signals[:, COL["noise"]] = self.noise.batch_compute(
            texts=corpus.texts if corpus.texts is not None else [None] * n,
            images=img_list,
            progress=m.update,
        )
        m.close()
        return corpus

    def process_corpus(self, corpus: Any, weights: Any = None,
                       delta: Optional[float] = None,
                       mode: Optional[str] = None,
                       progress: bool = False) -> Any:
        """Signals + fused fit-and-score, columnar end to end."""
        self.compute_signals_corpus(corpus, progress=progress)
        scorer = self._make_scorer(weights, delta)
        corpus.dewi = np.asarray(
            scorer.fit_and_score(
                corpus.signals, mode=mode or self.config.scoring.mode
            ),
            np.float32,
        )
        self._scorer = scorer
        return corpus

    @staticmethod
    def _slice_images(images: Any, a: int, b: int) -> Any:
        """Row-range view of any supported ``Corpus.images`` container.

        Plain ``images[a:b]`` covers all three: ndarray view, list slice,
        and PackedImages (whose ``__getitem__`` forwards slices to the
        mmap).  Never probe ``.data`` — every ndarray has one (a
        memoryview) and taking it breaks row indexing downstream.
        """
        return None if images is None else images[a:b]

    @staticmethod
    def _corpus_shard_digest(corpus: Any, a: int, b: int) -> str:
        """Content digest of shard rows — per-shard resume must recompute
        when the slice changed (same contract as ``_StageCheckpoint``:
        text CONTENT not length, image identity via path or a strided
        pixel sample, external embedding bytes, delimited fields so
        id/text boundaries can't alias across rows)."""
        import hashlib
        import os

        h = hashlib.sha256()
        texts = corpus.texts
        emb = corpus.embeddings
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        pack_path = getattr(corpus.images, "path", None)
        if pack_path is not None:
            # PackedImages: the pack file IS the image identity — hash its
            # path/size/mtime plus the row range ONCE instead of sampling
            # pixels per row (which would fault in the whole mmap).
            h.update(f"pack:{pack_path}:{a}:{b}".encode())
            try:
                st = os.stat(pack_path)
                h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                pass
        for i in range(a, b):
            h.update(str(corpus.ids[i]).encode())
            h.update(b"\0")
            t = texts[i] if texts is not None else None
            h.update((t or "").encode("utf-8", "replace"))
            h.update(b"\0")
            if corpus.has_image[i] and pack_path is None:
                src = corpus.images[i]
                if isinstance(src, (str, Path)):
                    h.update(str(src).encode())
                    try:
                        st = os.stat(src)
                        h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
                    except OSError:
                        pass
                else:
                    arr = np.ascontiguousarray(src)
                    h.update(str((arr.shape, str(arr.dtype))).encode())
                    flat = arr.reshape(-1).view(np.uint8)
                    h.update(flat[:: max(1, flat.size // 256)].tobytes())
            h.update(b"\0")
            if emb is not None and (ext_mask is None or ext_mask[i]):
                h.update(np.ascontiguousarray(emb[i]).tobytes())
            h.update(b"\1")
        return h.hexdigest()[:32]

    def process_stream_corpus(self, corpus: Any,
                              shard_size: Optional[int] = None,
                              checkpoint_dir: Optional[PathLike] = None,
                              weights: Any = None,
                              delta: Optional[float] = None,
                              mode: Optional[str] = None,
                              progress: bool = False) -> Any:
        """Sharded columnar pipeline: per-shard signals (+resume), global
        redundancy, one fused global fit+score.

        The columnar analogue of :meth:`process_stream`: corpora larger
        than HBM/RAM stream in ``shard_size`` row ranges (each shard's
        device-resident image upload covers only its slice), completed
        shards resume from an ``.npz`` checkpoint keyed to a content
        digest, and — like the object path — the cross-document redundancy
        stage and the robust-stat fit run GLOBALLY so sharding never
        changes a single score.
        """
        n = len(corpus)
        if n == 0:
            return corpus
        shard_size = int(shard_size or self.config.runtime.shard_size)
        ckpt_root = Path(checkpoint_dir) if checkpoint_dir else None
        if ckpt_root:
            ckpt_root.mkdir(parents=True, exist_ok=True)
            stale = sorted(
                p.name for p in ckpt_root.glob("shard_*") if p.is_dir()
            )
            if stale:
                # Object-path process_stream wrote per-stage npz files
                # under shard_NNNNN/ directories; this columnar format is
                # one .npz per shard.  Be loud rather than silently
                # recomputing everything a user thought was checkpointed.
                logger.warning(
                    "%s holds %d object-path shard directories (e.g. %s) "
                    "this columnar run cannot resume from; recomputing. "
                    "Use DewiPipeline.process_stream for the old format.",
                    ckpt_root, len(stale), stale[0],
                )
        n_shards = (n + shard_size - 1) // shard_size
        ext_mask = getattr(corpus, "ext_embedding_mask", None)
        # Original EXTERNAL embeddings (what shards may treat as supplied)
        # vs the accumulator shards fill — conflating them would hand
        # shard k>0 the zero placeholder rows as "external" vectors.
        orig_ext = corpus.embeddings
        emb_parent = (
            np.array(orig_ext, np.float32) if orig_ext is not None else None
        )
        filled_parent = np.zeros(n, bool)
        any_clip = False
        for s in range(n_shards):
            a, b = s * shard_size, min((s + 1) * shard_size, n)
            if progress:
                print(f"Shard {s + 1}/{n_shards} ({b - a} docs)")
            ck = ckpt_root / f"shard_{s:05d}.npz" if ckpt_root else None
            digest = (
                self._corpus_shard_digest(corpus, a, b) if ck else None
            )
            if ck is not None and ck.exists():
                try:
                    data = np.load(ck, allow_pickle=False)
                    if str(data["digest"]) == digest:
                        corpus.signals[a:b] = data["signals"]
                        if data["embeddings"].size:
                            if emb_parent is None:
                                emb_parent = np.zeros(
                                    (n, data["embeddings"].shape[1]),
                                    np.float32,
                                )
                            emb_parent[a:b] = data["embeddings"]
                        filled_parent[a:b] = data["clip_filled"]
                        any_clip = any_clip or bool(
                            data["clip_filled"].any()
                        )
                        continue
                    logger.warning(
                        "Shard %d checkpoint digest mismatch; recomputing.",
                        s,
                    )
                except Exception as e:  # noqa: BLE001 — corrupt ckpt
                    logger.warning(
                        "Shard %d checkpoint unreadable (%s); recomputing.",
                        s, e,
                    )
            from .corpus import Corpus

            sub = Corpus(
                ids=corpus.ids[a:b],
                texts=(
                    corpus.texts[a:b] if corpus.texts is not None else None
                ),
                images=self._slice_images(corpus.images, a, b),
                embeddings=(
                    np.array(orig_ext[a:b], np.float32)
                    if orig_ext is not None else None
                ),
                signals=corpus.signals[a:b],  # view: stages write through
            )
            if ext_mask is not None and not bool(ext_mask[a:b].all()):
                sub.ext_embedding_mask = ext_mask[a:b]
            self.compute_signals_corpus(sub, progress=progress,
                                        include_redundancy=False)
            if sub.embeddings is not None:
                if emb_parent is None:
                    emb_parent = np.zeros(
                        (n, sub.embeddings.shape[1]), np.float32
                    )
                emb_parent[a:b] = sub.embeddings
            sub_filled = getattr(
                sub, "clip_filled_mask", np.zeros(b - a, bool)
            )
            filled_parent[a:b] = sub_filled
            any_clip = any_clip or bool(np.asarray(sub_filled).any())
            if ck is not None:
                tmp = ck.with_suffix(".tmp.npz")
                np.savez(
                    tmp, digest=digest, signals=corpus.signals[a:b],
                    embeddings=(
                        sub.embeddings if sub.embeddings is not None
                        else np.zeros((0, 0), np.float32)
                    ),
                    clip_filled=np.asarray(sub_filled, bool),
                )
                tmp.replace(ck)
        corpus.embeddings = emb_parent
        corpus.clip_filled_mask = filled_parent
        corpus.clip_embedded = bool(
            any_clip and (ext_mask is None or not ext_mask.any())
            and (emb_parent is None or filled_parent.all())
        )
        # Cross-document stage LAST and GLOBAL (identical to the
        # monolithic path — shard boundaries must not hide duplicates).
        self._redundancy_corpus(corpus)
        scorer = self._make_scorer(weights, delta)
        corpus.dewi = np.asarray(
            scorer.fit_and_score(
                corpus.signals, mode=mode or self.config.scoring.mode
            ),
            np.float32,
        )
        self._scorer = scorer
        return corpus

    def build_index_corpus(self, corpus: Any,
                           **index_kwargs: Any) -> Any:
        """``Corpus`` -> built :class:`DewiIndex`: two array ops, no per-doc
        Python (vs ``build_index``'s per-doc stack, pipelines.py:804-806)."""
        if len(corpus) == 0:
            raise ValueError("No documents to index")
        self.ensure_embeddings_corpus(corpus)
        index = self._make_index(dim=int(corpus.embeddings.shape[1]),
                                 **index_kwargs)
        filled = getattr(corpus, "clip_filled_mask", None)
        if getattr(corpus, "clip_embedded", False):
            index.encoder = {"source": "cross_modal",
                             **self.encoder_provenance()}
        elif filled is not None and bool(filled.any()):
            # Some rows external, some CLIP-filled — same "mixed" provenance
            # the object path records (build_index below).
            index.encoder = {"source": "mixed", **self.encoder_provenance()}
        else:
            index.encoder = {"source": "external"}
        index.add_batch(list(corpus.ids),
                        np.asarray(corpus.embeddings, np.float32),
                        corpus.payload_matrix())
        index.build()
        return index

    # -- index handoff ------------------------------------------------------------

    def _make_index(self, dim: int, **index_kwargs: Any) -> Any:
        """Config-driven :class:`DewiIndex` construction (backend knobs,
        bf16 storage) shared by the Document and columnar build paths."""
        from .index import DewiIndex
        from .index.facade import IndexBackend

        cfg = self.config.index
        kwargs = dict(
            space=cfg.metric,
            backend=cfg.ann,
            ef=cfg.ef_construction,
            M=cfg.M,
            ef_query=cfg.ef_query,
            rerank_eta=cfg.rerank_eta,
            entropy_pref=cfg.entropy_pref,
        )
        try:
            resolved = IndexBackend.from_str(str(cfg.ann)).resolve().__name__
        except ValueError:
            resolved = "ExactIndex"
        if resolved == "ExactIndex":
            kwargs.update(blockmax_select=cfg.blockmax_select)
        elif resolved == "IVFIndex":
            # probe_dtype "auto" resolves inside IVFIndex.build from the
            # store's embedding dtype (bf16 store -> bf16 buckets).
            kwargs.update(nlist=cfg.nlist, nprobe=cfg.nprobe,
                          dewi_tier=cfg.dewi_tier,
                          probe_dtype=cfg.probe_dtype,
                          spill_frac=cfg.spill_frac)
        elif resolved == "QuantizedIndex":
            kwargs.update(refine_factor=cfg.refine_factor,
                          int8_queries=cfg.int8_queries,
                          bf16_scores=cfg.bf16_scores,
                          blockmax_select=cfg.blockmax_select,
                          int4_storage=(cfg.int4_storage
                                        or cfg.ann.lower() == "int4"))
        if self.config.mesh.dtype == "bfloat16":
            import jax.numpy as jnp

            kwargs["dtype"] = jnp.bfloat16  # halve index HBM traffic
        kwargs.update(index_kwargs)
        return DewiIndex(dim=dim, **kwargs)

    def build_index(self, documents: List[Document],
                    **index_kwargs: Any) -> Any:
        """Documents -> built :class:`DewiIndex` (embeddings + payloads)."""

        if not documents:
            raise ValueError("No documents to index")
        self.ensure_embeddings(documents)
        n_clip = sum(
            1 for d in documents if d.doc_id in self._clip_embedded_ids
        )
        index = self._make_index(dim=len(documents[0].embedding),
                                 **index_kwargs)
        if n_clip == 0:
            # Every embedding was supplied externally — the CLIP towers were
            # never consulted, so recording their identity would let search
            # confidently encode queries with an unrelated model.
            index.encoder = {"source": "external"}
        else:
            index.encoder = {
                "source": (
                    "cross_modal" if n_clip == len(documents) else "mixed"
                ),
                **self.encoder_provenance(),
            }
        emb = np.stack([d.embedding for d in documents]).astype(np.float32)
        pay = np.stack([d.payload().to_array() for d in documents])
        index.add_batch([d.doc_id for d in documents], emb, pay)
        index.build()
        return index


__all__ = ["Document", "DewiPipeline", "create_document"]
