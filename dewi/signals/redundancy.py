"""Redundancy estimation: embedding-space near-dup + minhash/simhash text dedup.

The reference ships only a CLIP text×image similarity matrix
(reference redundancy.py:19-39) while its config promises minhash/simhash
dedup (reference config.py:29-33) and its pipeline calls ``fit``/``score``
that don't exist (pipelines.py:148-151 — SURVEY.md §2.4 items 5, 8).  This
module implements the full promised surface with one coherent contract:

* ``compute_cross_modal_similarity(texts, images)`` — API parity with the
  reference method (an ``[N, M]`` cosine matrix from CLIP features).
* ``fit(embeddings)`` / ``score()`` — per-document redundancy = max
  off-diagonal cosine similarity to any other document, computed as
  blockwise jitted matmuls  (memory-bounded: never materializes
  the full ``[N, N]`` matrix).
* ``minhash_signatures`` / ``simhash_bits`` + LSH banding —
  hash-based text near-dup detection, host-side (string processing is not
  device work), with ``near_duplicate_clusters`` feeding
  :func:`dewi.metrics.duplicate_rate`.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Embedding-space redundancy (device path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("block", "chunk"))
def _max_offdiag_block(
    emb_n: jax.Array,       # [Np, D] normalized, zero-padded to chunk multiple
    n_valid: jax.Array,     # scalar int32: real corpus size
    start: jax.Array,
    block: int,
    chunk: int,
) -> jax.Array:
    """Max off-diagonal cosine of rows [start, start+block) vs the corpus.

    The corpus axis is scanned in ``chunk``-column tiles with a running max,
    so peak memory is ``block*chunk`` f32 — never ``block*N`` (a [4096, 1M]
    tile would be 16 GB; chunked it stays ~1 GB regardless of N)."""
    rows = jax.lax.dynamic_slice_in_dim(emb_n, start, block, axis=0)
    self_col = (start + jnp.arange(block))[:, None]
    n_chunks = emb_n.shape[0] // chunk

    def body(c: Any, best: jax.Array) -> jax.Array:
        cols = jax.lax.dynamic_slice_in_dim(emb_n, c * chunk, chunk, axis=0)
        sim = jnp.dot(rows, cols.T, preferred_element_type=jnp.float32)
        col = (c * chunk + jnp.arange(chunk))[None, :]
        sim = jnp.where((col == self_col) | (col >= n_valid), -jnp.inf, sim)
        return jnp.maximum(best, jnp.max(sim, axis=1))

    best = jax.lax.fori_loop(
        0, n_chunks, body, jnp.full((block,), -jnp.inf, jnp.float32)
    )
    # f32 matmuls may run at reduced precision (bf16 passes, TF32); clamp
    # so cosines stay in [-1, 1].
    return jnp.clip(best, -1.0, 1.0)


def max_offdiag_similarity(
    embeddings: np.ndarray, block: int = 4096, chunk: int = 65536
) -> np.ndarray:
    """Per-row max cosine similarity to any *other* row, blockwise on device."""
    emb = jnp.asarray(embeddings, dtype=jnp.float32)
    norm = jnp.maximum(jnp.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    emb = emb / norm
    n = emb.shape[0]
    if n < 2:
        return np.zeros(n, dtype=np.float32)
    block = min(block, n)
    chunk = min(chunk, max(block, 256))
    pad = (-n) % chunk
    if pad:
        emb = jnp.concatenate(
            [emb, jnp.zeros((pad, emb.shape[1]), emb.dtype)], axis=0
        )
    # Deferred fetches: all block dispatches queue on device, ONE host
    # round trip for the whole corpus (245 blocks at 1M docs = ~245 saved
    # round trips; overlapping clamped-last-block rows recompute identical
    # values, so write order is irrelevant).
    from ..utils.deferred import DeferredFetcher

    fetch = DeferredFetcher()
    spans = []
    for start in range(0, n, block):
        s = min(start, n - block)  # clamp last block; overlap rows recomputed
        fetch.append(
            _max_offdiag_block(emb, jnp.int32(n), jnp.int32(s), block, chunk)
        )
        spans.append(s)
    flat = fetch.result()
    out = np.empty(n, dtype=np.float32)
    for j, s in enumerate(spans):
        out[s : s + block] = flat[j * block : (j + 1) * block]
    return out


def max_offdiag_similarity_sharded(
    embeddings: np.ndarray,
    mesh: Any,
    block: int = 4096,
    chunk: int = 65536,
) -> np.ndarray:
    """Mesh-sharded max off-diagonal cosine (the O(N^2) redundancy stage).

    The corpus embeddings replicate over the mesh (1 GB at 1M x 256 — well
    inside one device's memory); each device computes the running-max scan for ITS
    row range against the full corpus, so the N^2 FLOPs split evenly over
    the ``data`` axis with zero collectives on the compute path (one
    all-gather materializes the [N] result).  Single-device meshes reduce
    to the same math as :func:`max_offdiag_similarity`; parity is asserted
    in tests/test_parallel_signals.py.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from ..parallel.mesh import DATA_AXIS

    emb = jnp.asarray(embeddings, dtype=jnp.float32)
    norm = jnp.maximum(jnp.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    emb = emb / norm
    n = emb.shape[0]
    if n < 2:
        return np.zeros(n, dtype=np.float32)
    ndev = int(mesh.shape[DATA_AXIS])
    block = max(8, min(block, -(-n // ndev)))
    # Pad rows so every device owns an equal whole number of row blocks;
    # chunk must divide the padded width (the column scan).
    rows_per_dev = -(-n // (ndev * block)) * block
    np_rows = rows_per_dev * ndev
    chunk = min(chunk, np_rows)
    while np_rows % chunk:
        chunk //= 2
    pad = np_rows - n
    if pad:
        emb = jnp.concatenate(
            [emb, jnp.zeros((pad, emb.shape[1]), emb.dtype)], axis=0
        )
    emb = jax.device_put(emb, NamedSharding(mesh, P()))  # replicate
    n_valid = jnp.int32(n)

    def shard_body(emb_full: jax.Array) -> jax.Array:
        i = jax.lax.axis_index(DATA_AXIS)
        start0 = i * rows_per_dev

        def row_block(b: Any, out: jax.Array) -> jax.Array:
            s = start0 + b * block
            rows = jax.lax.dynamic_slice_in_dim(emb_full, s, block, axis=0)
            self_col = (s + jnp.arange(block))[:, None]
            n_chunks = emb_full.shape[0] // chunk

            def body(c: Any, best: jax.Array) -> jax.Array:
                cols = jax.lax.dynamic_slice_in_dim(
                    emb_full, c * chunk, chunk, axis=0
                )
                sim = jnp.dot(rows, cols.T,
                              preferred_element_type=jnp.float32)
                col = (c * chunk + jnp.arange(chunk))[None, :]
                sim = jnp.where(
                    (col == self_col) | (col >= n_valid), -jnp.inf, sim
                )
                return jnp.maximum(best, jnp.max(sim, axis=1))

            # Carries become data-varying (start0 depends on axis_index);
            # mark the inits so scan's type check accepts the loop.
            init = jax.lax.pcast(
                jnp.full((block,), -jnp.inf, jnp.float32), (DATA_AXIS,),
                to="varying",
            )
            best = jax.lax.fori_loop(0, n_chunks, body, init)
            return jax.lax.dynamic_update_slice(
                out, jnp.clip(best, -1.0, 1.0), (b * block,)
            )

        out0 = jax.lax.pcast(
            jnp.zeros((rows_per_dev,), jnp.float32), (DATA_AXIS,),
            to="varying",
        )
        return jax.lax.fori_loop(0, rows_per_dev // block, row_block, out0)

    fn = jax.jit(shard_map(
        shard_body, mesh=mesh,
        in_specs=P(),
        out_specs=P(DATA_AXIS),
    ))
    return np.asarray(fn(emb))[:n]


@partial(jax.jit, static_argnames=("block", "chunk", "top"))
def _topk_density_block(
    emb_n: jax.Array,       # [Np, D] normalized, zero-padded to chunk multiple
    n_valid: jax.Array,     # scalar int32: real corpus size
    start: jax.Array,
    block: int,
    chunk: int,
    top: int,
) -> jax.Array:
    """Mean cosine of rows [start, start+block) to their ``top`` nearest
    *other* rows — a neighborhood-density estimate (vs the max-offdiag
    kernel's single nearest neighbor).  Same chunked scan, with a running
    per-row top-``top`` instead of a running max."""
    rows = jax.lax.dynamic_slice_in_dim(emb_n, start, block, axis=0)
    self_col = (start + jnp.arange(block))[:, None]
    n_chunks = emb_n.shape[0] // chunk

    def body(c: Any, best: Any) -> Any:
        cols = jax.lax.dynamic_slice_in_dim(emb_n, c * chunk, chunk, axis=0)
        sim = jnp.dot(rows, cols.T, preferred_element_type=jnp.float32)
        col = (c * chunk + jnp.arange(chunk))[None, :]
        sim = jnp.where((col == self_col) | (col >= n_valid), -jnp.inf, sim)
        merged, _ = jax.lax.top_k(jnp.concatenate([best, sim], axis=1), top)
        return merged

    best = jax.lax.fori_loop(
        0, n_chunks, body, jnp.full((block, top), -jnp.inf, jnp.float32)
    )
    finite = jnp.isfinite(best)
    cnt = jnp.maximum(finite.sum(axis=1), 1)
    # f32 matmuls may run at reduced precision (bf16 passes, TF32); clamp
    # so cosines stay in [-1, 1].
    vals = jnp.where(finite, jnp.clip(best, -1.0, 1.0), 0.0)
    return vals.sum(axis=1) / cnt


def topk_density(
    embeddings: np.ndarray, top: int = 8, block: int = 4096,
    chunk: int = 65536,
) -> np.ndarray:
    """Per-row mean cosine to its ``top`` nearest other rows, blockwise."""
    emb = jnp.asarray(embeddings, dtype=jnp.float32)
    norm = jnp.maximum(jnp.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    emb = emb / norm
    n = emb.shape[0]
    if n < 2:
        return np.zeros(n, dtype=np.float32)
    top = min(int(top), n - 1)
    block = min(block, n)
    chunk = min(chunk, max(block, 256))
    pad = (-n) % chunk
    if pad:
        emb = jnp.concatenate(
            [emb, jnp.zeros((pad, emb.shape[1]), emb.dtype)], axis=0
        )
    # Same deferred-fetch pattern as max_offdiag_similarity: one host
    # round trip for all block dispatches.
    from ..utils.deferred import DeferredFetcher

    fetch = DeferredFetcher()
    spans = []
    for start in range(0, n, block):
        s = min(start, n - block)  # clamp last block; overlap rows recomputed
        fetch.append(_topk_density_block(
            emb, jnp.int32(n), jnp.int32(s), block, chunk, top
        ))
        spans.append(s)
    flat = fetch.result()
    out = np.empty(n, dtype=np.float32)
    for j, s in enumerate(spans):
        out[s : s + block] = flat[j * block : (j + 1) * block]
    return out


# ---------------------------------------------------------------------------
# Hash-based text dedup (host path)
# ---------------------------------------------------------------------------

_MERSENNE = np.uint64((1 << 61) - 1)


def _shingles(text: str, k: int = 3) -> np.ndarray:
    """Word k-shingle hashes as uint64 (char 4-grams for short texts)."""
    words = text.lower().split()
    if len(words) >= k:
        grams = [" ".join(words[i : i + k]) for i in range(len(words) - k + 1)]
    else:
        t = text.lower()
        grams = [t[i : i + 4] for i in range(max(1, len(t) - 3))]
    import hashlib

    return np.unique(np.array(
        [
            int.from_bytes(hashlib.blake2b(g.encode(), digest_size=8).digest(), "little")
            for g in grams
        ],
        dtype=np.uint64,
    ))


def minhash_signatures(
    texts: Sequence[str], num_hashes: int = 64, seed: int = 0, k: int = 3
) -> np.ndarray:
    """``[N, H]`` uint64 minhash signatures (universal hashing a*x+b mod p).

    Uses the native C++ shingle hasher (dewi/native) when available —
    string processing is the host-side hot loop at corpus scale; the numpy
    path below is the fallback and the reference semantics.
    """
    from ..native import minhash_signatures_native

    native = minhash_signatures_native(texts, num_hashes, seed=seed, k=k)
    if native is not None:
        return native
    rng = np.random.default_rng(seed)
    a = rng.integers(1, int(_MERSENNE), size=num_hashes, dtype=np.uint64)
    b = rng.integers(0, int(_MERSENNE), size=num_hashes, dtype=np.uint64)
    sigs = np.full((len(texts), num_hashes), np.iinfo(np.uint64).max, np.uint64)
    for i, t in enumerate(texts):
        sh = _shingles(t, k)
        if sh.size == 0:
            continue
        # (a*x + b) mod p for every (hash, shingle) pair, min over shingles.
        prod = (sh[None, :] * a[:, None] + b[:, None]) % _MERSENNE
        sigs[i] = prod.min(axis=1)
    return sigs


_DCT32 = None


def _dct_matrix(n: int = 32) -> np.ndarray:
    global _DCT32
    if _DCT32 is None:
        i = np.arange(n)
        _DCT32 = np.sqrt(2.0 / n) * np.cos(
            np.pi * (2 * i[None, :] + 1) * i[:, None] / (2 * n)
        )
        _DCT32[0] /= np.sqrt(2.0)
    return _DCT32


def phash64(image: Any, hash_size: int = 8) -> np.uint64:
    """DCT-based 64-bit perceptual hash (the ``image_sim: "phash"`` mode the
    reference config promises at config.py:32 but never implements).

    Classic pHash: 32x32 luma -> 2D DCT-II -> top-left 8x8 low-frequency
    block (DC excluded from the median) -> bit i = coef_i > median.
    """
    from .image_entropy import to_image_array

    arr = to_image_array(image, 32)
    luma = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    d = _dct_matrix(32)
    coefs = d @ luma @ d.T
    block = coefs[:hash_size, :hash_size].ravel()
    med = np.median(block[1:])  # exclude DC
    bits = block > med
    out = np.uint64(0)
    for i, b in enumerate(bits):
        if b:
            out |= np.uint64(1) << np.uint64(i)
    return out


def phash_similarity(a: np.uint64, b: np.uint64, bits: int = 64) -> float:
    """1 - normalized Hamming distance of two perceptual hashes."""
    return 1.0 - bin(int(a) ^ int(b)).count("1") / bits


def simhash_bits(texts: Sequence[str], bits: int = 64, k: int = 3) -> np.ndarray:
    """``[N]`` uint64 simhash fingerprints over shingle hashes."""
    out = np.zeros(len(texts), dtype=np.uint64)
    weights = np.array([1 << i for i in range(bits)], dtype=np.uint64)
    for i, t in enumerate(texts):
        sh = _shingles(t, k)
        if sh.size == 0:
            continue
        bitmat = ((sh[:, None] >> np.arange(bits, dtype=np.uint64)[None, :]) & 1)
        counts = bitmat.sum(axis=0)
        majority = counts * 2 >= sh.size
        out[i] = np.sum(weights[majority], dtype=np.uint64)
    return out


def _lsh_candidate_pairs(sigs: np.ndarray, bands: int = 16) -> List[tuple]:
    """Candidate near-dup pairs by banding the signature matrix."""
    n, h = sigs.shape
    rows = h // bands
    buckets: Dict[bytes, List[int]] = {}
    for band in range(bands):
        chunk = sigs[:, band * rows : (band + 1) * rows]
        for i in range(n):
            key = bytes([band]) + chunk[i].tobytes()
            buckets.setdefault(key, []).append(i)
    pairs = set()
    for members in buckets.values():
        if len(members) < 2:
            continue
        for ai in range(len(members)):
            for bi in range(ai + 1, len(members)):
                pairs.add((members[ai], members[bi]))
    return sorted(pairs)


class _UnionFind:
    def __init__(self, n: int) -> None:
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


# ---------------------------------------------------------------------------
# Estimator façade
# ---------------------------------------------------------------------------


class RedundancyEstimator:
    """One coherent redundancy contract (resolves SURVEY.md §2.4 items 5, 8).

    Accepts the union of the reference ctor (redundancy.py:20) and the kwargs
    its pipeline passes (pipelines.py:70-74).
    """

    def __init__(
        self,
        model_name: str = "small",
        device: str = "cpu",
        text_sim: str = "embedding",
        image_sim: str = "embedding",
        cross_modal_density: bool = True,
        block_size: int = 4096,
        threshold: float = 0.9,
        num_hashes: int = 64,
        clip: Optional[object] = None,  # shared CrossModalDependency
        seed: int = 0,
        mesh: Any = None,
    ) -> None:
        del device
        # Data-parallel mesh: the O(N^2) embedding-redundancy scan splits
        # its row range over the 'data' axis (max_offdiag_similarity_sharded).
        self.mesh = mesh
        self.text_sim = text_sim
        self.image_sim = image_sim
        self.cross_modal_density = bool(cross_modal_density)
        self.block_size = int(block_size)
        self.threshold = float(threshold)
        self.num_hashes = int(num_hashes)
        self.seed = int(seed)
        self._clip = clip
        self._model_name = model_name
        self._embeddings: Optional[np.ndarray] = None
        self._scores: Optional[np.ndarray] = None

    def _get_clip(self) -> Any:
        if self._clip is None:
            from .cross_modal import CrossModalDependency

            self._clip = CrossModalDependency(model_name=self._model_name,
                                              seed=self.seed)
        return self._clip

    # -- parity method -------------------------------------------------------

    def compute_cross_modal_similarity(
        self, texts: Sequence[str], images: Sequence
    ) -> np.ndarray:
        """``[N, M]`` text×image cosine matrix (parity: redundancy.py:28-39)."""
        return self._get_clip().similarity_matrix(texts, images)

    # -- coherent corpus contract ---------------------------------------------

    def fit(self, embeddings: np.ndarray) -> "RedundancyEstimator":
        """Register corpus embeddings for redundancy scoring."""
        self._embeddings = np.asarray(embeddings, dtype=np.float32)
        self._scores = None
        return self

    def score(self, embeddings: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-doc redundancy in [-1, 1]: max off-diagonal cosine similarity."""
        emb = self._embeddings if embeddings is None else np.asarray(embeddings)
        if emb is None:
            raise ValueError("Call fit(embeddings) or pass embeddings")
        if self._scores is None or embeddings is not None:
            if self.mesh is not None and self.mesh.devices.size > 1:
                scores = max_offdiag_similarity_sharded(
                    emb, self.mesh, block=self.block_size
                )
            else:
                scores = max_offdiag_similarity(emb, block=self.block_size)
            if embeddings is None:
                self._scores = scores
            return scores
        return self._scores

    def cross_modal_density_scores(
        self, embeddings: np.ndarray, top: int = 8
    ) -> np.ndarray:
        """Joint-embedding neighborhood density for multimodal documents.

        ``embeddings`` are the pipeline's *joint* text+image CLIP vectors
        (normalized mean of both towers, pipelines.py ``ensure_embeddings``);
        the score is each doc's mean cosine to its ``top`` nearest joint
        neighbors.  This is the ``cross_modal_density`` signal the reference
        config declares but never computes (reference config.py:33): a doc
        sitting in a dense region of the joint text×image space — many docs
        pairing similar captions with similar images — is cross-modally
        redundant even when lexical minhash sees distinct strings.
        """
        return topk_density(
            np.asarray(embeddings, dtype=np.float32),
            top=top, block=self.block_size,
        )

    def score_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Hash-mode per-doc redundancy (estimated max Jaccard / simhash sim)."""
        n = len(texts)
        out = np.zeros(n, dtype=np.float32)
        if n < 2:
            return out
        if self.text_sim == "simhash":
            fps = simhash_bits(texts)
            # Band the 64-bit fingerprint into 4 x 16-bit keys.
            sigs = np.stack(
                [(fps >> np.uint64(16 * i)) & np.uint64(0xFFFF) for i in range(4)],
                axis=1,
            ).astype(np.uint64)
            pairs = _lsh_candidate_pairs(sigs, bands=4)
            for a, b in pairs:
                ham = bin(int(fps[a]) ^ int(fps[b])).count("1")
                sim = 1.0 - ham / 64.0
                out[a] = max(out[a], sim)
                out[b] = max(out[b], sim)
        else:  # minhash (default hash mode)
            sigs = minhash_signatures(texts, self.num_hashes, seed=self.seed)
            pairs = _lsh_candidate_pairs(sigs, bands=16)
            for a, b in pairs:
                sim = float(np.mean(sigs[a] == sigs[b]))
                out[a] = max(out[a], sim)
                out[b] = max(out[b], sim)
        return out

    def score_images(self, images: Sequence) -> np.ndarray:
        """Per-image redundancy via perceptual hashing (``image_sim: "phash"``).

        pHash each image, band the 64-bit fingerprints into 4 x 16-bit LSH
        keys, and report each image's max hash similarity to any candidate —
        the image analogue of :meth:`score_texts`'s simhash mode.
        """
        n = len(images)
        out = np.zeros(n, dtype=np.float32)
        if n < 2:
            return out
        fps = np.array([phash64(im) for im in images], dtype=np.uint64)
        sigs = np.stack(
            [(fps >> np.uint64(16 * i)) & np.uint64(0xFFFF) for i in range(4)],
            axis=1,
        ).astype(np.uint64)
        for a, b in _lsh_candidate_pairs(sigs, bands=4):
            sim = phash_similarity(fps[a], fps[b])
            out[a] = max(out[a], sim)
            out[b] = max(out[b], sim)
        return out

    def near_duplicate_clusters(
        self,
        texts: Optional[Sequence[str]] = None,
        embeddings: Optional[np.ndarray] = None,
        threshold: Optional[float] = None,
    ) -> List[List[int]]:
        """Union-find clusters of near-duplicates above ``threshold``.

        Output feeds :func:`dewi.metrics.duplicate_rate` /
        :func:`dewi.metrics.cluster_coverage`.
        """
        thr = self.threshold if threshold is None else float(threshold)
        if texts is not None:
            sigs = minhash_signatures(texts, self.num_hashes, seed=self.seed)
            pairs = [
                (a, b)
                for a, b in _lsh_candidate_pairs(sigs, bands=16)
                if float(np.mean(sigs[a] == sigs[b])) >= thr
            ]
            n = len(texts)
        elif embeddings is not None:
            emb = np.asarray(embeddings, dtype=np.float32)
            emb = emb / np.maximum(
                np.linalg.norm(emb, axis=1, keepdims=True), 1e-12
            )
            n = len(emb)
            pairs = []
            for s in range(0, n, self.block_size):
                blockrows = emb[s : s + self.block_size]
                sim = blockrows @ emb.T
                for i in range(len(blockrows)):
                    sim[i, s + i] = -1.0
                hits = np.argwhere(sim >= thr)
                pairs.extend((s + int(i), int(j)) for i, j in hits)
        else:
            raise ValueError("Provide texts or embeddings")
        uf = _UnionFind(n)
        for a, b in pairs:
            uf.union(a, b)
        clusters: Dict[int, List[int]] = {}
        for i in range(n):
            clusters.setdefault(uf.find(i), []).append(i)
        return sorted(clusters.values())


__all__ = [
    "RedundancyEstimator",
    "max_offdiag_similarity",
    "topk_density",
    "minhash_signatures",
    "simhash_bits",
    "phash64",
    "phash_similarity",
]
