"""Distributed DEWI search: shard_map over the corpus axis.

Replaces both C++ ANN query paths (reference backends.py:217, 326) with the
mesh-native pattern from SURVEY.md §5/§7: each device holds a block of the
document axis, computes its fused similarity + DEWI re-rank + local
``lax.top_k(k)``, then the ``(score, global_id)`` candidate lists are
all-gathered over the interconnect and merged with one more top-k.  Communication per
query is ``O(n_devices * k)`` floats — independent of corpus size.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.similarity import fused_search, topk_merge
from .mesh import DATA_AXIS, data_sharding


def make_sharded_search(mesh: Mesh, k: int, normalize: bool = True,
                        blockmax_select: bool = True) -> Any:
    """Build a jitted sharded-search callable for a fixed (mesh, k, space).

    The returned function takes device arrays laid out as:
      emb [cap, D] sharded on data axis, sqn [cap] sharded,
      pay [cap, 8] sharded, queries [Q, D] replicated,
      n_valid / eta / entropy_pref scalars replicated,
    and returns replicated ([Q, k] scores, [Q, k] global row indices).

    ``blockmax_select`` (default on) swaps each shard's flat ``lax.top_k``
    for the value-exact hierarchical block-max select
    (ops/similarity.fused_search; the two-pass score-gather variant, no
    query-count gate).  Misaligned shard capacities fall back inside
    fused_search.
    """

    def local_search(emb: jax.Array, sqn: jax.Array, pay: jax.Array,
                     queries: jax.Array, n_valid: jax.Array,
                     eta: jax.Array, entropy_pref: jax.Array) -> Any:
        shard = jax.lax.axis_index(DATA_AXIS)
        shard_cap = emb.shape[0]
        local_n = jnp.clip(n_valid - shard * shard_cap, 0, shard_cap)
        k_local = min(k, shard_cap)
        vals, idx = fused_search(
            emb, sqn, pay, queries, local_n, eta, entropy_pref,
            k=k_local, normalize=normalize, blockmax_select=blockmax_select,
        )
        gidx = idx + shard * shard_cap
        all_vals = jax.lax.all_gather(vals, DATA_AXIS, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(gidx, DATA_AXIS, axis=1, tiled=True)
        return topk_merge(all_vals, all_idx, min(k, all_vals.shape[1]))

    sharded = jax.shard_map(
        local_search,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS, None), P(), P(), P(), P()),
        out_specs=(P(), P()),
        # Outputs are replicated by construction (deterministic merge of the
        # all-gathered candidates); VMA can't infer that statically.
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_quantized_search(mesh: Mesh, k: int, m: int,
                                  normalize: bool = True,
                                  int8_queries: bool = False,
                                  bf16_scores: bool = False,
                                  blockmax_select: bool = False,
                                  bmax_kernel: bool = False,
                                  interpret: bool = False,
                                  int4_packed: bool = False,
                                  int4_values: bool = False) -> Any:
    """Sharded two-stage int8 search: local int8 scan + f32 refine per shard,
    then the same all-gather/top-k merge as the exact path.  Stage-1 memory
    traffic per device is the int8 shard — 4x less than f32.

    ``int8_queries`` quantizes the replicated query too (int8 x int8
    stage 1).  ``blockmax_select`` swaps the per-shard candidate select for
    the exact hierarchical sub-block-max (ops/quantized.py); with
    ``bmax_kernel`` each shard's stage 1 is the fused kernel, so its
    [Q, cap] scores never reach device memory.  ``int4_packed`` reads the
    shard as the nibble-packed int4 corpus (half the per-device stage-1
    stream; quantized_search widens its selection margins internally)."""
    from ..ops.quantized import quantized_search

    def local_search(emb_i8: jax.Array, scales: jax.Array,
                     emb: jax.Array, sqn: jax.Array, pay: jax.Array,
                     queries: jax.Array, n_valid: jax.Array,
                     eta: jax.Array, entropy_pref: jax.Array) -> Any:
        shard = jax.lax.axis_index(DATA_AXIS)
        shard_cap = emb.shape[0]
        local_n = jnp.clip(n_valid - shard * shard_cap, 0, shard_cap)
        k_local = min(k, shard_cap)
        vals, idx = quantized_search(
            emb_i8, scales, emb, sqn, pay, queries, local_n, eta,
            entropy_pref, k=k_local, m=min(m, shard_cap),
            normalize=normalize, int8_queries=int8_queries,
            bf16_scores=bf16_scores, blockmax_select=blockmax_select,
            bmax_kernel=bmax_kernel, interpret=interpret,
            int4_packed=int4_packed, int4_values=int4_values,
        )
        gidx = idx + shard * shard_cap
        all_vals = jax.lax.all_gather(vals, DATA_AXIS, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(gidx, DATA_AXIS, axis=1, tiled=True)
        return topk_merge(all_vals, all_idx, min(k, all_vals.shape[1]))

    sharded = jax.shard_map(
        local_search,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS, None),
            P(DATA_AXIS), P(DATA_AXIS, None), P(), P(), P(), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


class ShardedQuantizedSearcher:
    """Sharded ScaNN-style search: int8 shard scans + f32 refinement.

    The distributed counterpart of :class:`dewi.index.QuantizedIndex`;
    quantization happens once at attach time, sharded over the data axis.
    On the GPU each shard's stage 1 is the fused kernel whenever blockmax
    selection is on and the shard shape fits it.
    """

    def __init__(self, store: Any, mesh: Mesh, k: int = 10,
                 refine_factor: int = 8, int8_queries: bool = False,
                 bf16_scores: bool = False, blockmax_select: bool = True,
                 int4_storage: bool = False) -> None:
        from ..ops.pallas_search import kernel_fits, kernel_runs_here
        from ..ops.quantized import (
            BLOCKMAX_SUB,
            quantize_rows,
            quantize_rows_int4,
            stage1_mode,
            unpack_int4,
        )

        self.store = store
        self.mesh = mesh
        self.k = k
        # int8 x int8 stage 1 (see QuantizedIndex).
        self.int8_queries = bool(int8_queries)
        # bf16 stage-1 score matrix on the XLA path (see QuantizedIndex).
        self.bf16_scores = bool(bf16_scores)
        # Hierarchical sub-block-max candidate selection per shard (see
        # QuantizedIndex.blockmax_select).
        self.blockmax_select = bool(blockmax_select)
        # int4 nibble-packed shard storage (see QuantizedIndex.int4_storage):
        # half the per-device stage-1 read; implies int8_queries and a
        # 4x-wider refine margin.
        self.int4_storage = bool(int4_storage)
        if self.int4_storage:
            self.int8_queries = True
        store.sharding = data_sharding(mesh, rank=2)
        emb, _, _, _ = store.device_arrays()
        shard_cap = store.capacity // mesh.shape[DATA_AXIS]
        self._kernel = (
            self.blockmax_select
            and kernel_runs_here()
            and shard_cap >= 4 * BLOCKMAX_SUB
            and kernel_fits(shard_cap, store.dim,
                            stage1_mode(self.int8_queries, self.int4_storage))
        )
        # Row-wise quantization preserves the data-axis sharding.
        if self.int4_storage:
            packed, self._scales = quantize_rows_int4(emb)
            # Only the kernel reads packed nibbles; elsewhere unpack ONCE
            # (it preserves the sharding) instead of per dispatch.
            self._q_emb = packed if self._kernel else unpack_int4(packed)
        else:
            self._q_emb, self._scales = quantize_rows(emb)
        m = max(32, k * refine_factor * (4 if self.int4_storage else 1))
        self._fn = make_sharded_quantized_search(
            mesh, k, m, normalize=store.normalize,
            int8_queries=self.int8_queries, bf16_scores=self.bf16_scores,
            blockmax_select=self.blockmax_select, bmax_kernel=self._kernel,
            int4_packed=self.int4_storage and self._kernel,
            int4_values=self.int4_storage and not self._kernel,
        )

    def search_batch(self, queries: np.ndarray, eta: float = 0.5,
                     entropy_pref: float = 0.0) -> Any:
        emb, sqn, pay, n = self.store.device_arrays()
        q = jnp.atleast_2d(jnp.asarray(queries, dtype=jnp.float32))
        return self._fn(
            self._q_emb, self._scales, emb, sqn, pay, q, n,
            jnp.float32(eta), jnp.float32(entropy_pref),
        )


def make_sharded_ivf_search(mesh: Mesh, k: int, nprobe_per_shard: int,
                            normalize: bool = True,
                            dedup: bool = False) -> Any:
    """Sharded IVF search: buckets (and their centroids) are sharded over the
    data axis; each device scores its local centroid shard, probes its local
    top-``nprobe_per_shard`` buckets, scans its overflow slice exactly, and
    the candidates merge with the usual all-gather + top-k.

    Probing semantics are *per shard* (total probes = n_devices *
    nprobe_per_shard, spread by where the clusters live) — the natural
    distributed variant of nprobe; with ``nprobe_per_shard = local nlist``
    it degenerates to exact search.

    ``dedup=True`` is REQUIRED for spill-built indexes (spill_frac > 0):
    a doc's primary and spill copies can land on different shards, so the
    per-shard kernel dedup alone cannot prevent the same id appearing
    twice in the merged top-k — the merge re-runs the id-dedup over the
    gathered candidates.
    """
    from ..index.ivf import _dedup_topk, _ivf_search_kernel

    def local_search(centroids: jax.Array, b_emb: jax.Array,
                     b_pay: jax.Array, b_valid: jax.Array,
                     b_docidx: jax.Array, b_sqn: jax.Array,
                     o_emb: jax.Array, o_pay: jax.Array,
                     o_docidx: jax.Array, o_sqn: jax.Array,
                     queries: jax.Array, eta: jax.Array,
                     entropy_pref: jax.Array) -> Any:
        nprobe = min(nprobe_per_shard, centroids.shape[0])
        # Clamp k to the PROBED candidate pool (nprobe buckets + overflow),
        # not the whole shard — the kernel's top_k axis is the pool.
        k_local = min(
            k, nprobe * b_docidx.shape[1] + o_docidx.shape[0]
        )
        vals, idx = _ivf_search_kernel(
            centroids, b_emb, b_pay, b_valid, b_docidx, b_sqn,
            o_emb, o_pay, o_docidx, o_sqn,
            jnp.int32(o_emb.shape[0]),  # padded slots carry docidx == -1
            queries, eta, entropy_pref,
            k=k_local, nprobe=nprobe, normalize=normalize,
            dedup=dedup,
        )
        # b_docidx/o_docidx hold GLOBAL store row ids — no shard offset.
        all_vals = jax.lax.all_gather(vals, DATA_AXIS, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(idx, DATA_AXIS, axis=1, tiled=True)
        k_out = min(k, all_vals.shape[1])
        if dedup:
            # Cross-shard copies carry bit-equal scores, so positional
            # first-keep over the (unsorted) gathered rows is exact.
            return _dedup_topk(all_vals, all_idx, k_out)
        return topk_merge(all_vals, all_idx, k_out)

    sharded = jax.shard_map(
        local_search,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None),                       # centroids
            P(DATA_AXIS, None, None),                 # b_emb
            P(DATA_AXIS, None, None),                 # b_pay
            P(DATA_AXIS, None),                       # b_valid
            P(DATA_AXIS, None),                       # b_docidx
            P(DATA_AXIS, None),                       # b_sqn
            P(DATA_AXIS, None),                       # o_emb
            P(DATA_AXIS, None),                       # o_pay
            P(DATA_AXIS),                             # o_docidx
            P(DATA_AXIS),                             # o_sqn
            P(), P(), P(),                            # queries, eta, ep
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


class ShardedIVFSearcher:
    """Distributed counterpart of :class:`dewi.index.IVFIndex`.

    Takes a built IVFIndex, pads its bucket/overflow arrays to the mesh's
    data-axis size, and re-places them sharded; queries fan out once and
    candidates merge over the interconnect (O(n_devices * k) floats per
    query).
    """

    def __init__(self, ivf_index: Any, mesh: Mesh, k: int = 10,
                 nprobe_per_shard: Optional[int] = None) -> None:
        if ivf_index._dev is None:
            ivf_index.build()
        self.k = k
        n_dev = mesh.shape[DATA_AXIS]
        (centroids, b_emb, b_pay, b_valid, b_docidx, b_sqn,
         o_emb, o_pay, o_docidx, o_sqn, o_n) = ivf_index._dev

        def pad0(a: np.ndarray, mult: int, fill: Any = 0) -> np.ndarray:
            pad = (-a.shape[0]) % mult
            if not pad:
                return a
            filler = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
            return jnp.concatenate([a, filler])

        # Pad the bucket axis (empty buckets: valid=False, docidx=-1) and the
        # overflow axis (docidx=-1 marks padded slots) to shard evenly.
        centroids = pad0(centroids, n_dev)
        b_emb = pad0(b_emb, n_dev)
        b_pay = pad0(b_pay, n_dev)
        b_valid = pad0(b_valid, n_dev, fill=False)
        b_docidx = pad0(b_docidx, n_dev, fill=-1)
        b_sqn = pad0(b_sqn, n_dev)
        # Truncate overflow to its live region first so padding is explicit.
        o_live = int(o_n)
        o_emb, o_pay = o_emb[:o_live], o_pay[:o_live]
        o_docidx, o_sqn = o_docidx[:o_live], o_sqn[:o_live]
        o_emb = pad0(o_emb, n_dev)
        o_pay = pad0(o_pay, n_dev)
        o_docidx = pad0(o_docidx, n_dev, fill=-1)
        o_sqn = pad0(o_sqn, n_dev)
        if o_emb.shape[0] == 0:  # keep shard shapes nonempty
            o_emb = jnp.zeros((n_dev, o_emb.shape[1]), o_emb.dtype)
            o_pay = jnp.zeros((n_dev, o_pay.shape[1]), o_pay.dtype)
            o_docidx = jnp.full((n_dev,), -1, o_docidx.dtype)
            o_sqn = jnp.zeros((n_dev,), o_sqn.dtype)

        shard2 = data_sharding(mesh, rank=2)
        shard1 = data_sharding(mesh, rank=1)
        shard3 = data_sharding(mesh, rank=3)
        self._dev = (
            jax.device_put(centroids, shard2),
            jax.device_put(b_emb, shard3),
            jax.device_put(b_pay, shard3),
            jax.device_put(b_valid, shard2),
            jax.device_put(b_docidx, shard2),
            jax.device_put(b_sqn, shard2),
            jax.device_put(o_emb, shard2),
            jax.device_put(o_pay, shard2),
            jax.device_put(o_docidx, shard1),
            jax.device_put(o_sqn, shard1),
        )
        local_nlist = centroids.shape[0] // n_dev
        if nprobe_per_shard is None:
            nprobe_per_shard = max(1, -(-ivf_index.nprobe // n_dev))
        self._fn = make_sharded_ivf_search(
            mesh, k, min(nprobe_per_shard, local_nlist),
            normalize=ivf_index.store.normalize,
            # Spill-built buckets can hold a doc twice, possibly on
            # different shards — dedup locally AND at the merge.
            dedup=getattr(ivf_index, "spill_frac", 0.0) > 0.0,
        )

    def search_batch(self, queries: np.ndarray, eta: float = 0.5,
                     entropy_pref: float = 0.0) -> Any:
        q = jnp.atleast_2d(jnp.asarray(queries, dtype=jnp.float32))
        return self._fn(
            *self._dev, q, jnp.float32(eta), jnp.float32(entropy_pref)
        )


class ShardedExactSearcher:
    """Convenience wrapper: shard a DocStore over a mesh and serve queries."""

    def __init__(self, store: Any, mesh: Mesh, k: int = 10,
                 blockmax_select: bool = True) -> None:
        self.store = store
        self.mesh = mesh
        self.k = k
        self.blockmax_select = bool(blockmax_select)
        store.sharding = data_sharding(mesh, rank=2)
        self._fn = make_sharded_search(mesh, k, normalize=store.normalize,
                                       blockmax_select=self.blockmax_select)

    def search_batch(
        self,
        queries: np.ndarray,
        eta: float = 0.5,
        entropy_pref: float = 0.0,
        k: Optional[int] = None,
    ) -> Any:
        if k is not None and k != self.k:
            self.k = k
            self._fn = make_sharded_search(
                self.mesh, k, normalize=self.store.normalize,
                blockmax_select=self.blockmax_select)
        emb, sqn, pay, n = self.store.device_arrays()
        q = jnp.atleast_2d(jnp.asarray(queries, dtype=jnp.float32))
        return self._fn(
            emb, sqn, pay, q, n, jnp.float32(eta), jnp.float32(entropy_pref)
        )
