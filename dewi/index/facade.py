"""DewiIndex: the public index façade.

API parity with the reference façade (reference index.py:22-166): same
constructor signature, ``add/build/search/save/load/get_payload/
get_embedding/get_metadata/__len__``, same ``config.json``/``meta.json``
persistence layout.  Backend selection maps the reference's C++ ANN names
onto device backends:

* ``exact`` / ``bruteforce``          -> :class:`ExactIndex` (fused matmul top-k)
* ``ivf`` / ``faiss_ivfflat``         -> :class:`IVFIndex`   (k-means + probed buckets)
* ``hnsw`` / ``faiss_hnsw`` / ``auto`` -> ExactIndex — on an accelerator the exact
  matmul path is faster than a graph walk at these scales, so graph ANN is
  replaced rather than ported (SURVEY.md §2.2).
"""

from __future__ import annotations

import json
import logging
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..types import Payload
from .base import BaseIndex
from .exact import ExactIndex

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]


class IndexBackend(Enum):
    """Supported device index backends (parity: reference backends.py:32-49)."""

    EXACT = "exact"
    IVF = "ivf"
    QUANTIZED = "quantized"
    # Reference-compat aliases — resolved to device backends.
    HNSW = "hnsw"
    FAISS_IVFFLAT = "faiss_ivfflat"
    FAISS_HNSW = "faiss_hnsw"

    @classmethod
    def from_str(cls, name: str) -> "IndexBackend":
        name = name.lower()
        if name in ("auto", "bruteforce"):
            return cls.EXACT
        if name in ("int8", "scann", "int4"):
            return cls.QUANTIZED
        return cls(name)

    def resolve(self) -> type:
        from .ivf import IVFIndex
        from .quantized import QuantizedIndex

        if self in (IndexBackend.IVF, IndexBackend.FAISS_IVFFLAT):
            return IVFIndex
        if self is IndexBackend.QUANTIZED:
            return QuantizedIndex
        if self in (IndexBackend.HNSW, IndexBackend.FAISS_HNSW):
            logger.info("Graph ANN replaced by exact matmul top-k backend.")
            return ExactIndex
        return ExactIndex


class DewiIndex:
    """Entropy-weighted index with DEWI re-ranked search.

    ``ef``/``M`` are accepted for reference-API compatibility
    (reference index.py:23-31) but intentionally inert: they tune HNSW graph
    construction, and graph ANN is replaced by exact/quantized/IVF matmul
    backends on the accelerator (the equivalent dials are ``refine_factor`` and
    ``nlist``/``nprobe``)."""

    def __init__(
        self,
        dim: int,
        space: str = "cosine",
        backend: Union[str, IndexBackend] = "auto",
        ef: int = 200,
        M: int = 32,
        use_ann: bool = True,
        ef_query: int = 200,
        rerank_eta: float = 0.25,
        entropy_pref: float = 0.0,
        **kwargs: Any,
    ) -> None:
        self.dim = int(dim)
        self.space = space
        self._meta: Dict[str, Dict[str, Any]] = {}
        self.ef_query = ef_query
        self.rerank_eta = float(rerank_eta)
        self.entropy_pref = float(entropy_pref)
        # Embedding provenance (encoder preset/tokenizer/seed/checkpoint) —
        # set by DewiPipeline.build_index, persisted in config.json, and
        # consumed by CLI search/eval to reconstruct a matching query encoder.
        self.encoder: Optional[Dict[str, Any]] = None
        self._built = False
        self._use_ann = bool(use_ann)

        if isinstance(backend, str):
            if backend.lower() == "int4":
                # "int4" selects the quantized backend's nibble-packed
                # storage tier (half the stage-1 HBM stream).
                kwargs.setdefault("int4_storage", True)
            try:
                backend = IndexBackend.from_str(backend)
            except ValueError:
                # Reference behavior: unknown backend name falls back to exact
                # (reference index.py:44-48).
                logger.warning("Unknown backend %r; using ExactIndex.", backend)
                backend = IndexBackend.EXACT

        if not self._use_ann:
            self._backend: BaseIndex = ExactIndex(dim, space, **kwargs)
        else:
            cls = backend.resolve()
            self._backend = cls(dim, space, **kwargs)

    # -- ingest ----------------------------------------------------------------

    def add(
        self,
        doc_id: str,
        embedding: np.ndarray,
        payload: Payload,
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        if meta is not None:
            self._meta[doc_id] = meta
        self._backend.add(doc_id, np.asarray(embedding, dtype=np.float32), payload)
        self._built = False

    def add_batch(self, doc_ids: Sequence[str], embeddings: np.ndarray,
                  payloads: np.ndarray) -> None:
        """Bulk ingest (device-native path; no reference counterpart)."""
        self._backend.add_batch(doc_ids, embeddings, payloads)
        self._built = False

    def build(self) -> None:
        self._backend.build()
        self._built = True

    def set_dewi_scores(self, scores: np.ndarray) -> None:
        """Write freshly computed DEWI scores into every payload (column 0).

        The bulk re-score path: fit+score the corpus with
        :meth:`DewiScorer.fit_and_score`, then push the result here in one
        call — no per-document payload mutation."""
        self._backend.store.set_dewi_scores(scores)
        self._built = False  # quantized/IVF tiers must re-sync payloads

    # -- search ----------------------------------------------------------------

    def search(
        self,
        query: np.ndarray,
        k: int = 10,
        eta: Optional[float] = None,
        entropy_pref: Optional[float] = None,
    ) -> List[Tuple[str, float, Payload]]:
        if not self._built:
            self.build()
        if eta is None:
            eta = self.rerank_eta
        if entropy_pref is None:
            entropy_pref = self.entropy_pref
        q = np.asarray(query, dtype=np.float32)
        if q.shape != (self.dim,):
            raise ValueError(f"Expected query shape ({self.dim},), got {q.shape}")
        return self._backend.search(q, k, eta, entropy_pref)

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        eta: Optional[float] = None,
        entropy_pref: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched device search: [Q, D] -> ([Q, k] scores, [Q, k] row indices)."""
        if not self._built:
            self.build()
        if eta is None:
            eta = self.rerank_eta
        if entropy_pref is None:
            entropy_pref = self.entropy_pref
        return self._backend.search_batch(queries, k, eta, entropy_pref)

    # -- accessors ----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._backend)

    @property
    def doc_ids(self) -> List[str]:
        return self._backend.store.doc_ids

    def get_payload(self, doc_id: str) -> Optional[Payload]:
        return self._backend.get_payload(doc_id)

    def get_embedding(self, doc_id: str) -> Optional[np.ndarray]:
        return self._backend.store.get_embedding(doc_id)

    def get_metadata(self, doc_id: str) -> Optional[Dict[str, Any]]:
        return self._meta.get(doc_id)

    # -- persistence ----------------------------------------------------------------

    def save(self, path: PathLike, write_jsonl: bool = True) -> None:
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        self._backend.save(p / "ann_index", write_jsonl=write_jsonl)
        with open(p / "config.json", "w", encoding="utf-8") as f:
            json.dump(
                {
                    "dim": self.dim,
                    "space": self.space,
                    "use_ann": self._use_ann,
                    "ef_query": self.ef_query,
                    "rerank_eta": self.rerank_eta,
                    "entropy_pref": self.entropy_pref,
                    "built": self._built,
                    "backend_type": self._backend.__class__.__name__,
                    "encoder": self.encoder,
                },
                f,
            )
        if self._meta:
            with open(p / "meta.json", "w", encoding="utf-8") as f:
                json.dump(self._meta, f)

    @classmethod
    def load(cls, path: PathLike) -> "DewiIndex":
        p = Path(path)
        with open(p / "config.json", "r", encoding="utf-8") as f:
            cfg = json.load(f)
        backend_type = cfg.get("backend_type", "ExactIndex")

        from . import BACKEND_CLASSES

        ann_cls = BACKEND_CLASSES.get(backend_type, ExactIndex)
        ann = ann_cls.load(p / "ann_index")
        inst = cls(
            dim=cfg["dim"],
            space=cfg["space"],
            backend="exact",
            use_ann=cfg.get("use_ann", True),
            ef_query=cfg.get("ef_query", 200),
            rerank_eta=cfg.get("rerank_eta", 0.25),
            entropy_pref=cfg.get("entropy_pref", 0.0),
        )
        inst._backend = ann
        inst._built = bool(cfg.get("built", False))
        inst.encoder = cfg.get("encoder")
        meta_path = p / "meta.json"
        if meta_path.exists():
            with open(meta_path, "r", encoding="utf-8") as f:
                inst._meta = json.load(f)
        return inst
