"""Abstract index interface + shared persistence.

Disk format parity with the reference (backends.py:104-163, 483-556):
``metadata.json`` (dim/space/doc_ids/is_trained/type) + ``payloads.jsonl``
(one ``{"doc_id": ..., "payload": {...}}`` line per doc; the reference's
BaseIndex variant used ``"id"`` — both are accepted on load) + array files.
For large corpora a binary fast path (``payloads.npy`` / ``doc_ids.json``)
is written alongside and preferred on load.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..types import Payload
from .store import DocStore

PathLike = Union[str, Path]


class BaseIndex:
    """Base class for device index implementations (parity: backends.py:54-163)."""

    def __init__(self, dim: int, space: str = "cosine",
                 **kwargs: Any) -> None:
        self.dim = int(dim)
        self.space = space
        self.store = DocStore(dim, space, **_store_kwargs(kwargs))
        self._is_trained = False

    # -- shared surface ------------------------------------------------------

    @property
    def _doc_ids(self) -> List[str]:
        # Reference-compatible attribute (backends.py:68); used by DewiIndex.
        return self.store.doc_ids

    def __len__(self) -> int:
        return len(self.store)

    def add(self, doc_id: str, embedding: np.ndarray, payload: Payload) -> None:
        self.store.add(doc_id, embedding, payload)

    def add_batch(self, doc_ids: Sequence[str], embeddings: np.ndarray,
                  payloads: np.ndarray) -> None:
        self.store.add_batch(doc_ids, embeddings, payloads)

    def build(self, **kwargs: Any) -> None:
        raise NotImplementedError

    def search(
        self,
        query: np.ndarray,
        k: int = 10,
        eta: float = 0.5,
        entropy_pref: float = 0.0,
    ) -> List[Tuple[str, float, Payload]]:
        raise NotImplementedError

    def get_payload(self, doc_id: str) -> Optional[Payload]:
        return self.store.get_payload(doc_id)

    def _hyperparams(self) -> dict:
        """Backend-specific constructor kwargs to persist across save/load.

        Subclasses with tuning knobs (IVF nlist/nprobe, Quantized
        refine_factor, ...) override this so a saved index reloads with the
        hyperparameters it was built with rather than constructor defaults."""
        return {}

    # -- persistence -----------------------------------------------------------

    def save(self, path: PathLike, write_jsonl: bool = True) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        metadata = {
            "dim": self.dim,
            "space": self.space,
            "doc_ids": self.store.doc_ids,
            "normalize": self.store.normalize,
            "is_trained": self._is_trained,
            "num_embeddings": len(self.store),
            "type": self.__class__.__name__,
            "hyperparams": self._hyperparams(),
        }
        with open(path / "metadata.json", "w") as f:
            json.dump(metadata, f)

        pay = self.store.payload_matrix()
        np.save(path / "payloads.npy", pay)
        if write_jsonl:
            # Native C++ codec with Python fallback (dewi/native).
            from ..native import write_payloads_jsonl

            write_payloads_jsonl(path / "payloads.jsonl", self.store.doc_ids, pay)
        if len(self.store):
            np.save(path / "embeddings.npy", self.store.embedding_matrix())

    @classmethod
    def load(cls, path: PathLike, **kwargs: Any) -> "BaseIndex":
        path = Path(path)
        with open(path / "metadata.json") as f:
            metadata = json.load(f)

        from . import BACKEND_CLASSES

        index_cls = BACKEND_CLASSES.get(metadata.get("type", ""), cls)
        if index_cls is BaseIndex:
            from .exact import ExactIndex

            index_cls = ExactIndex
        # Saved hyperparameters are restored unless explicitly overridden by
        # the caller, so an IVF index built with nlist=1024/nprobe=32 reloads
        # with those values, not constructor defaults.
        hyper = dict(metadata.get("hyperparams", {}))
        hyper.update(kwargs)
        index = index_cls(dim=metadata["dim"], space=metadata["space"], **hyper)

        doc_ids = metadata["doc_ids"]
        emb_path = path / "embeddings.npy"
        pay_npy = path / "payloads.npy"
        if emb_path.exists() and doc_ids:
            emb = np.load(emb_path).astype(np.float32)
            if pay_npy.exists():
                pay = np.load(pay_npy).astype(np.float32)
            else:
                pay = _payloads_from_jsonl(path, doc_ids)
            index.add_batch(doc_ids, emb, pay)
        index._is_trained = bool(metadata.get("is_trained", False))
        if index._is_trained and len(index):
            index.build()
        return index


def _payloads_from_jsonl(path: Path, doc_ids: List[str]) -> np.ndarray:
    jsonl = path / "payloads.jsonl"
    by_id = {}
    if jsonl.exists():
        from ..native import read_payloads_jsonl

        ids, mat = read_payloads_jsonl(jsonl)
        by_id = {i: row for i, row in zip(ids, mat)}
    blank = Payload().to_array()
    return np.stack([by_id.get(i, blank) for i in doc_ids])


def _store_kwargs(kwargs: dict) -> dict:
    return {k: v for k, v in kwargs.items() if k in ("capacity", "dtype", "sharding")}
