"""Struct-of-arrays document store with XLA-friendly capacity growth.

The reference keeps documents as Python lists of per-doc objects and dicts
(reference backends.py:66-69, 394-406).  On the device everything numeric lives in
fixed-capacity device arrays instead:

* ``embeddings [cap, D] f32`` — row-normalized on device when cosine,
* ``payloads   [cap, 8] f32`` — PAYLOAD_FIELDS columns (dewi first),
* ``sqnorms    [cap]``        — row squared norms for the L2 path,

with a host-side id table.  ``cap`` grows by power-of-two doubling so XLA
recompiles the fused search kernel only O(log N) times; rows beyond the live
count are masked out inside the kernel (see ops/similarity.fused_search).

Payload mutability parity: the reference README flow mutates the object
returned by ``get_payload`` in place (README.md:104-110).  ``get_payload``
here hands out live ``Payload`` instances that are flushed back into the
payload matrix on the next device sync, so that flow keeps working.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..types import PAYLOAD_FIELDS, Payload, payloads_to_matrix

MIN_CAPACITY = 1024


def _next_capacity(n: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


class DocStore:
    """Growable SoA store for (doc_id, embedding, payload) triples."""

    def __init__(
        self,
        dim: int,
        space: str = "cosine",
        capacity: int = MIN_CAPACITY,
        dtype: Any = jnp.float32,
        sharding: Optional[jax.sharding.Sharding] = None,
    ) -> None:
        if space not in ("cosine", "l2"):
            raise ValueError(f"space must be 'cosine' or 'l2', got {space!r}")
        self.dim = int(dim)
        self.space = space
        self.normalize = space == "cosine"
        self.dtype = dtype
        self._sharding = sharding

        cap = _next_capacity(capacity)
        self._emb = np.zeros((cap, self.dim), dtype=np.float32)
        self._pay = np.zeros((cap, len(PAYLOAD_FIELDS)), dtype=np.float32)
        self._ids: List[str] = []
        self._id_to_idx: Dict[str, int] = {}
        self._live: Dict[int, Payload] = {}
        self._dirty = True
        self._device: Optional[tuple] = None
        self._host_stale = False
        # Adds arriving while the store is device-resident buffer here and
        # merge on device at the next device_arrays() — a per-add host pull
        # of the whole corpus would be a perf trap at scale.
        self._pending_emb: List[np.ndarray] = []
        self._pending_pay: List[np.ndarray] = []

    @property
    def sharding(self) -> Optional[jax.sharding.Sharding]:
        return self._sharding

    @sharding.setter
    def sharding(self, value: Optional[jax.sharding.Sharding]) -> None:
        """Changing placement invalidates cached device arrays (they must be
        re-placed under the new sharding on the next sync)."""
        if value is not self._sharding:
            self._sharding = value
            if self._device is not None:
                self._sync_host()  # preserve data attached device-side
                self._device = None
                self._dirty = True

    # ---- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._ids)

    @property
    def capacity(self) -> int:
        if self._host_stale and self._device is not None:
            return int(self._device[0].shape[0])
        return self._emb.shape[0]

    @property
    def doc_ids(self) -> List[str]:
        return self._ids

    def index_of(self, doc_id: str) -> Optional[int]:
        return self._id_to_idx.get(doc_id)

    # ---- mutation ----------------------------------------------------------

    def _ensure_capacity(self, n: int) -> None:
        if n <= self.capacity:
            return
        cap = _next_capacity(n)
        emb = np.zeros((cap, self.dim), dtype=np.float32)
        pay = np.zeros((cap, len(PAYLOAD_FIELDS)), dtype=np.float32)
        # The host mirror may hold fewer rows than len(self): after
        # attach_device + buffered add()s, _sync_host grows capacity while
        # pending rows are still unwritten — copy only what exists.
        k = min(len(self), self._emb.shape[0])
        emb[:k] = self._emb[:k]
        pay[:k] = self._pay[:k]
        self._emb, self._pay = emb, pay
        self._dirty = True

    def add(self, doc_id: str, embedding: np.ndarray, payload: Payload) -> None:
        emb = np.asarray(embedding, dtype=np.float32)
        if emb.shape != (self.dim,):
            raise ValueError(
                f"Expected embedding of shape {(self.dim,)}, got {emb.shape}"
            )
        idx = len(self)
        if self._host_stale:
            # Device-resident store: buffer the row; merged on device at the
            # next device_arrays() (no corpus-sized host round trip).
            self._pending_emb.append(emb)
            self._pending_pay.append(np.asarray(payload.to_array(), np.float32))
            self._ids.append(doc_id)
            self._id_to_idx[doc_id] = idx
            return
        self._ensure_capacity(idx + 1)
        self._emb[idx] = emb
        self._pay[idx] = payload.to_array()
        self._ids.append(doc_id)
        self._id_to_idx[doc_id] = idx
        self._dirty = True

    def add_batch(
        self,
        doc_ids: Sequence[str],
        embeddings: np.ndarray,
        payloads: Union[np.ndarray, Sequence[Payload]],
    ) -> None:
        """Bulk ingest: the device-native path (one memcpy, no per-doc Python)."""
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"Expected [N, {self.dim}] embeddings, got {emb.shape}")
        if not isinstance(payloads, np.ndarray):
            payloads = payloads_to_matrix(list(payloads))
        pay = np.asarray(payloads, dtype=np.float32)
        n_new = emb.shape[0]
        if len(doc_ids) != n_new or pay.shape != (n_new, len(PAYLOAD_FIELDS)):
            raise ValueError("doc_ids / embeddings / payloads length mismatch")
        start = len(self)
        if self._host_stale:
            self._pending_emb.extend(emb)
            self._pending_pay.extend(pay)
            for i, d in enumerate(doc_ids):
                self._id_to_idx[str(d)] = start + i
            self._ids.extend(str(d) for d in doc_ids)
            return
        self._ensure_capacity(start + n_new)
        self._emb[start : start + n_new] = emb
        self._pay[start : start + n_new] = pay
        for i, d in enumerate(doc_ids):
            self._id_to_idx[str(d)] = start + i
        self._ids.extend(str(d) for d in doc_ids)
        self._dirty = True

    def attach_device(
        self,
        doc_ids: Sequence[str],
        embeddings: jax.Array,
        payloads: jax.Array,
    ) -> None:
        """Zero-copy ingest of already-device-resident arrays.

        The bulk path for corpora generated or scored on the accelerator:
        arrays are padded to capacity and normalized on device; nothing
        round-trips through host RAM (the host mirror is fetched lazily only
        if payload accessors or persistence need it).  Replaces the store's
        current contents.
        """
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(
                f"Expected [N, {self.dim}] embeddings, got {embeddings.shape}"
            )
        n = embeddings.shape[0]
        if len(doc_ids) != n or payloads.shape != (n, len(PAYLOAD_FIELDS)):
            raise ValueError("doc_ids / embeddings / payloads length mismatch")
        cap = _next_capacity(n)
        emb = jnp.asarray(embeddings, jnp.float32)
        pay = jnp.asarray(payloads, jnp.float32)
        if cap > n:
            emb = jnp.concatenate(
                [emb, jnp.zeros((cap - n, self.dim), jnp.float32)]
            )
            pay = jnp.concatenate(
                [pay, jnp.zeros((cap - n, len(PAYLOAD_FIELDS)), jnp.float32)]
            )
        if self.normalize:
            from ..ops.similarity import l2_normalize

            emb = l2_normalize(emb)
        emb = emb.astype(self.dtype)
        sqn = jnp.sum(jnp.square(emb.astype(jnp.float32)), axis=-1)
        if self.sharding is not None:
            emb = jax.device_put(emb, self.sharding)
            pay = jax.device_put(pay, self.sharding)
        self._ids = [str(d) for d in doc_ids]
        self._id_to_idx = {d: i for i, d in enumerate(self._ids)}
        self._live = {}
        # attach replaces the corpus wholesale: buffered adds from a
        # previous attachment must not leak into the new arrays.
        self._pending_emb, self._pending_pay = [], []
        self._device = (emb, sqn, pay, jnp.int32(n))
        self._dirty = False
        self._host_stale = True
        # Host mirrors become placeholders; fetched on demand.
        self._emb = np.zeros((0, self.dim), dtype=np.float32)
        self._pay = np.zeros((0, len(PAYLOAD_FIELDS)), dtype=np.float32)

    def _sync_host(self) -> None:
        """Fetch host mirrors from device after :meth:`attach_device`,
        folding in any still-buffered adds."""
        if not getattr(self, "_host_stale", False):
            return
        emb, _, pay, n = self._device
        self._emb = np.asarray(emb, dtype=np.float32)
        self._pay = np.asarray(pay, dtype=np.float32)
        self._host_stale = False
        if self._pending_emb:
            n_dev = int(n)
            self._ensure_capacity(len(self._ids))
            new_emb = np.stack(self._pending_emb)
            new_pay = np.stack(self._pending_pay)
            self._emb[n_dev : n_dev + len(new_emb)] = new_emb
            self._pay[n_dev : n_dev + len(new_pay)] = new_pay
            self._pending_emb, self._pending_pay = [], []
            self._dirty = True

    def set_payload(self, doc_id: str, payload: Payload) -> None:
        self._sync_host()
        idx = self._id_to_idx[doc_id]
        self._pay[idx] = payload.to_array()
        self._live.pop(idx, None)
        self._dirty = True

    def set_payload_matrix(self, matrix: np.ndarray) -> None:
        """Overwrite all live payload rows at once (bulk re-score path)."""
        self._sync_host()
        mat = np.asarray(matrix, dtype=np.float32)
        if mat.shape != (len(self), len(PAYLOAD_FIELDS)):
            raise ValueError(
                f"Expected [{len(self)}, {len(PAYLOAD_FIELDS)}] payloads, got {mat.shape}"
            )
        self._pay[: len(self)] = mat
        self._live.clear()
        self._dirty = True

    def set_dewi_scores(self, scores: np.ndarray) -> None:
        """Write freshly computed DEWI scores into payload column 0."""
        self._sync_host()
        scores = np.asarray(scores, dtype=np.float32).reshape(-1)
        if scores.shape[0] != len(self):
            raise ValueError("scores length != number of documents")
        self._pay[: len(self), 0] = scores
        for idx, p in self._live.items():
            p.dewi = float(scores[idx])
        self._dirty = True

    # ---- reads -------------------------------------------------------------

    def get_payload(self, doc_id: str) -> Optional[Payload]:
        idx = self._id_to_idx.get(doc_id)
        if idx is None:
            return None
        self._sync_host()
        if idx not in self._live:
            self._live[idx] = Payload.from_array(self._pay[idx])
        return self._live[idx]

    def get_embedding(self, doc_id: str) -> Optional[np.ndarray]:
        idx = self._id_to_idx.get(doc_id)
        if idx is None:
            return None
        self._sync_host()
        return self._emb[idx].copy()

    def payload_matrix(self) -> np.ndarray:
        self._sync_host()
        self._flush_live()
        return self._pay[: len(self)]

    def embedding_matrix(self) -> np.ndarray:
        self._sync_host()
        return self._emb[: len(self)]

    # ---- device sync ---------------------------------------------------------

    def _merge_pending_on_device(self) -> None:
        emb_d, sqn_d, pay_d, n_d = self._device
        n_old = int(n_d)
        total = len(self._ids)
        cap = _next_capacity(total)
        if cap > emb_d.shape[0]:
            grow = cap - emb_d.shape[0]
            emb_d = jnp.concatenate(
                [emb_d, jnp.zeros((grow, self.dim), emb_d.dtype)]
            )
            sqn_d = jnp.concatenate([sqn_d, jnp.zeros((grow,), sqn_d.dtype)])
            pay_d = jnp.concatenate(
                [pay_d, jnp.zeros((grow, pay_d.shape[1]), pay_d.dtype)]
            )
        new_emb = jnp.asarray(np.stack(self._pending_emb), jnp.float32)
        if self.normalize:
            from ..ops.similarity import l2_normalize

            new_emb = l2_normalize(new_emb)
        new_sqn = jnp.sum(jnp.square(new_emb), axis=-1)
        new_pay = jnp.asarray(np.stack(self._pending_pay), jnp.float32)
        emb_d = jax.lax.dynamic_update_slice(
            emb_d, new_emb.astype(emb_d.dtype), (n_old, 0)
        )
        sqn_d = jax.lax.dynamic_update_slice(sqn_d, new_sqn, (n_old,))
        pay_d = jax.lax.dynamic_update_slice(pay_d, new_pay, (n_old, 0))
        if self.sharding is not None:
            emb_d = jax.device_put(emb_d, self.sharding)
            pay_d = jax.device_put(pay_d, self.sharding)
        self._device = (emb_d, sqn_d, pay_d, jnp.int32(total))
        self._pending_emb, self._pending_pay = [], []

    def _flush_live(self) -> None:
        """Write back any handed-out Payload objects the user may have mutated."""
        for idx, p in self._live.items():
            row = p.to_array()
            if not np.array_equal(row, self._pay[idx]):
                self._pay[idx] = row
                self._dirty = True

    def device_arrays(self) -> Any:
        """Return (embeddings, sqnorms, payloads, n_valid) device arrays.

        Embeddings are L2-normalized rows for cosine space (normalization is
        a one-time jitted kernel at sync, not per-query work).  Arrays are
        cached until the store is mutated; re-placed under ``self.sharding``
        when one is set (data-axis corpus sharding over the mesh).
        """
        self._flush_live()
        if self._host_stale:
            # Device-resident store: merge buffered adds on device (only the
            # new rows cross the host boundary, never the corpus).
            if self._pending_emb:
                self._merge_pending_on_device()
            return self._device
        if self._device is not None and not self._dirty:
            return self._device

        emb = jnp.asarray(self._emb)
        if self.normalize:
            from ..ops.similarity import l2_normalize

            emb = l2_normalize(emb)
        emb = emb.astype(self.dtype)
        sqn = jnp.sum(jnp.square(emb.astype(jnp.float32)), axis=-1)
        pay = jnp.asarray(self._pay)
        if self.sharding is not None:
            emb = jax.device_put(emb, self.sharding)
            pay = jax.device_put(pay, self.sharding)
            sqn_sharding = self.sharding
            if isinstance(self.sharding, jax.sharding.NamedSharding):
                # Row-sharded rank-2 spec -> rank-1 spec for the sqnorm vector.
                axis0 = self.sharding.spec[0] if len(self.sharding.spec) else None
                sqn_sharding = jax.sharding.NamedSharding(
                    self.sharding.mesh, jax.sharding.PartitionSpec(axis0)
                )
            sqn = jax.device_put(sqn, sqn_sharding)
        n = jnp.int32(len(self))
        self._device = (emb, sqn, pay, n)
        self._dirty = False
        return self._device
