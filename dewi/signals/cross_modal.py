"""Cross-modal dependency (text↔image mutual-information proxy) via CLIP.

API parity with the reference estimator (reference cross_modal.py:15-157):
``CrossModalResult`` fields, ``compute_similarity`` / ``batch_compute`` /
``__call__``, batch path computing the full similarity matrix and taking its
diagonal (cross_modal.py:132-139).

Device-first: both towers are jitted Flax models; a batch is two tower forwards
plus one matmul — no per-pair Python loop.  The text tower doubles as
the query encoder for search (fixes SURVEY.md §2.4 item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.registry import clip_config, init_clip, maybe_load
from .image_entropy import ImageLike, normalize_images
from .tokenizer import get_tokenizer


@dataclass
class CrossModalResult:
    """Parity: reference cross_modal.py:9-13."""

    info_nce_score: float
    text_to_image_sim: float
    image_to_text_sim: float


class CrossModalDependency:
    """CLIP text↔image cosine similarity as an InfoNCE MI lower-bound proxy."""

    def __init__(
        self,
        model_name: str = "small",
        device: Optional[str] = None,
        batch_size: int = 128,
        tokenizer: str = "byte",
        checkpoint: Optional[str] = None,
        seed: int = 0,
        io_threads: int = 4,
        image_size: Optional[int] = None,
        mesh: Any = None,
    ) -> None:
        del device
        self.batch_size = int(batch_size)
        self.io_threads = int(io_threads)
        # Data-parallel mesh execution: params replicate, tower batches
        # shard over the 'data' axis (parallel/signals.py) — replaces the
        # reference's single-GPU CLIP forwards (cross_modal.py:124-147).
        self._dp = None
        if mesh is not None:
            from ..parallel.signals import DataParallel

            self._dp = DataParallel(mesh)
            self.batch_size = self._dp.round_batch(self.batch_size)
        self.tokenizer = get_tokenizer(tokenizer)
        from ..models.import_hf import sidecar_config

        side = sidecar_config(checkpoint)
        if side is not None:
            from ..models.clip import CLIPConfig

            self.cfg = CLIPConfig(**side["config"])
            if image_size is not None \
                    and int(image_size) != self.cfg.image_size:
                raise ValueError(
                    f"cross_modal.image_size={image_size} conflicts with "
                    f"checkpoint {checkpoint!r} (trained at "
                    f"{self.cfg.image_size}px; its positional embeddings "
                    f"fix the resolution). Drop the override or the "
                    f"checkpoint."
                )
            if self.cfg.vocab_size != self.tokenizer.vocab_size:
                # Hard error, matching TextEntropyEstimator: similarities
                # from a mismatched tokenizer are silently meaningless.
                raise ValueError(
                    f"CLIP checkpoint {checkpoint!r} expects a "
                    f"{self.cfg.vocab_size}-token vocabulary but tokenizer "
                    f"{tokenizer!r} has {self.tokenizer.vocab_size}. "
                    f"Configure the matching tokenizer "
                    f"(cross_modal/text config)."
                )
        else:
            over = {}
            if image_size is not None:
                self.cfg = clip_config(model_name)  # preset, for patch_size
                if int(image_size) % self.cfg.patch_size:
                    raise ValueError(
                        f"cross_modal.image_size={image_size} is not a "
                        f"multiple of the {model_name!r} patch size "
                        f"({self.cfg.patch_size})."
                    )
                over["image_size"] = int(image_size)
            self.cfg = clip_config(
                model_name, vocab_size=self.tokenizer.vocab_size, **over
            )
        self.model, params = init_clip(self.cfg, seed=seed)
        self.params = maybe_load(params, checkpoint)
        if self._dp is not None:
            self.params = self._dp.replicate(self.params)

        @jax.jit
        def _encode_text(params: Any, ids: jax.Array,
                         mask: jax.Array) -> jax.Array:
            return self.model.apply(
                params, ids, mask, method=self.model.encode_text
            )

        @jax.jit
        def _encode_image(params: Any, images: jax.Array) -> jax.Array:
            return self.model.apply(
                params, normalize_images(images),
                method=self.model.encode_image,
            )

        # Superbatch variants: S chunks per dispatch (see text_entropy).
        @jax.jit
        def _encode_text_super(params: Any, ids3: jax.Array,
                               mask3: jax.Array) -> jax.Array:
            return jax.lax.map(
                lambda xm: _encode_text(params, xm[0], xm[1]), (ids3, mask3)
            )

        # Packed transfer (uint16 ids, mask derived on device) — see
        # text_entropy.py; 4x less host->device traffic per token.
        pad_id = int(self.tokenizer.pad_id)

        text_vocab = int(self.cfg.vocab_size)

        @jax.jit
        def _encode_text_super_packed(params: Any,
                                      ids3_u16: jax.Array) -> jax.Array:
            def one(ids_u16: jax.Array) -> jax.Array:
                ids = ids_u16.astype(jnp.int32)
                mask = (ids != pad_id).astype(jnp.float32)
                # Out-of-vocab pad sentinel (HF adapters): zero before the
                # embedding gather; pad positions are attention-masked.
                if pad_id >= text_vocab:
                    ids = jnp.where(ids != pad_id, ids, 0)
                return _encode_text(params, ids, mask)

            return jax.lax.map(one, ids3_u16)

        self._encode_text_super_packed = _encode_text_super_packed
        self._packed_ok = bool(
            getattr(self.tokenizer, "pad_is_exclusive", False)
        )

        @jax.jit
        def _encode_image_super(params: Any,
                                images4: jax.Array) -> jax.Array:
            return jax.lax.map(
                lambda im: _encode_image(params, im), images4
            )

        self._encode_text = _encode_text
        self._encode_image = _encode_image
        self._encode_text_super = _encode_text_super
        self._encode_image_super = _encode_image_super
        self.superbatch = 8

    # -- encoders (shared with search + redundancy) ---------------------------

    def _dev(self, arr: Any, batch_axis: int = 0) -> Any:
        """Batch placement: plain device array, or sharded over the mesh's
        data axis when this estimator runs data-parallel."""
        if self._dp is None:
            return jnp.asarray(arr)
        return self._dp.put(arr, batch_axis)

    def encode_texts(self, texts: Sequence[str],
                     progress: Optional[Callable[[int], None]] = None
                     ) -> np.ndarray:
        """L2-normalized text embeddings ``[N, d_embed]``."""
        if not len(texts):
            return np.zeros((0, self.cfg.d_embed), np.float32)
        bs = self.batch_size
        tl = self.cfg.text_len

        def padded(start: int) -> Any:
            chunk = list(texts[start : start + bs])
            ids, mask = self.tokenizer.encode_batch(chunk, tl, pad_to=tl)
            pad = bs - len(chunk)
            if pad:
                ids = np.concatenate(
                    [ids, np.full((pad, tl), self.tokenizer.pad_id, np.int32)]
                )
                mask = np.concatenate([mask, np.zeros((pad, tl), np.float32)])
            return ids, mask, pad

        def padded_u16(start: int) -> Any:
            chunk = list(texts[start : start + bs])
            ids = self.tokenizer.encode_batch_u16(chunk, tl, pad_to=tl)
            pad = bs - len(chunk)
            if pad:
                ids = np.concatenate(
                    [ids,
                     np.full((pad, tl), self.tokenizer.pad_id, np.uint16)]
                )
            return ids, pad

        def dispatch(group_starts: Any) -> Any:
            """Tokenize + launch one supergroup; returns (pads, device e3)."""
            if self._packed_ok:
                group16 = [padded_u16(s) for s in group_starts]
                pads = [g[1] for g in group16]
                e3 = self._encode_text_super_packed(
                    self.params,
                    self._dev(np.stack([g[0] for g in group16]), 1),
                )
            else:
                group = [padded(s) for s in group_starts]
                pads = [g[2] for g in group]
                e3 = self._encode_text_super(
                    self.params,
                    self._dev(np.stack([g[0] for g in group]), 1),
                    self._dev(np.stack([g[1] for g in group]), 1),
                )
            return pads, e3

        # Deferred fetches (utils/deferred.py): supergroups launch back to
        # back with NO per-group host round trip; the whole embedding matrix
        # comes back in one fetch (budget-flushed for corpora whose device
        # results would crowd HBM).  Host tokenization still overlaps device
        # compute — dispatch is async.
        from ..utils.deferred import DeferredFetcher

        fetch = DeferredFetcher()
        starts = list(range(0, len(texts), bs))
        S = max(1, int(self.superbatch))
        pos = 0
        while len(starts) - pos >= S:
            pads, e3 = dispatch(starts[pos : pos + S])
            in_bytes = S * bs * tl * (2 if self._packed_ok else 8)
            for i, pad in enumerate(pads):
                fetch.append(e3[i], keep=bs - pad,
                             cost=in_bytes if i == 0 else 0)
            if progress is not None:
                progress(sum(bs - p for p in pads))
            pos += S
        for s in starts[pos:]:
            # Remainder batches keep the packed uint16 transfer by riding
            # the super kernel with a leading G=1 axis (one extra
            # [1, bs, tl] trace; 4x fewer bytes than int32+mask).
            if self._packed_ok:
                ids16, pad = padded_u16(s)
                e1 = self._encode_text_super_packed(
                    self.params, self._dev(ids16[None], 1)
                )
                fetch.append(e1[0], keep=bs - pad, cost=ids16.nbytes)
            else:
                ids, mask, pad = padded(s)
                e = self._encode_text(
                    self.params, self._dev(ids), self._dev(mask)
                )
                fetch.append(e, keep=bs - pad,
                             cost=ids.nbytes + mask.nbytes)
            if progress is not None:
                progress(bs - pad)
        return fetch.result()

    def _padded_image_batches(self, images: Sequence[ImageLike],
                              bs: int) -> Any:
        """``(batch [bs, S, S, 3], pad)`` stream: direct slices of a
        pre-decoded corpus array, else prefetch-decoded uint8 batches
        (host decode overlaps the previous batch's tower forward)."""
        from ..io.images import iter_corpus_batches

        yield from iter_corpus_batches(
            images, self.cfg.image_size, bs,
            threads=self.io_threads, depth=max(2, self.superbatch),
        )

    def encode_images(self, images: Sequence[ImageLike],
                      progress: Optional[Callable[[int], None]] = None
                      ) -> np.ndarray:
        """L2-normalized image embeddings ``[N, d_embed]``."""
        if not len(images):
            return np.zeros((0, self.cfg.d_embed), np.float32)
        bs = self.batch_size
        S = max(1, int(self.superbatch))
        group = []
        # Deferred fetches: no per-supergroup host round trip; one fetch of
        # the whole embedding matrix at the end (budget-flushed at scale).
        from ..utils.deferred import DeferredFetcher

        fetch = DeferredFetcher()

        def flush_group() -> None:
            if not group:
                return
            if len(group) == S:
                chunks = [c for c, _ in group]
                stacked = (
                    jnp.stack(chunks) if isinstance(chunks[0], jax.Array)
                    else np.stack(chunks)
                )  # device chunks stack on device (DeviceImages corpus)
                e3 = self._encode_image_super(self.params,
                                              self._dev(stacked, 1))
                in_bytes = (
                    0 if isinstance(chunks[0], jax.Array)
                    else int(stacked.size) * stacked.dtype.itemsize
                )
                for i, (_, pad) in enumerate(group):
                    fetch.append(e3[i], keep=bs - pad,
                                 cost=in_bytes if i == 0 else 0)
            else:
                for chunk, pad in group:
                    e = self._encode_image(self.params, self._dev(chunk))
                    cost = (
                        0 if isinstance(chunk, jax.Array)
                        else getattr(chunk, "nbytes", 0)
                    )
                    fetch.append(e, keep=bs - pad, cost=cost)
            if progress is not None:
                progress(sum(bs - p for _, p in group))
            group.clear()

        for chunk, pad in self._padded_image_batches(images, bs):
            group.append((chunk, pad))
            if len(group) == S:
                flush_group()
        flush_group()
        return fetch.result()

    # -- public API -----------------------------------------------------------

    def compute_similarity(self, text: str, image: ImageLike) -> CrossModalResult:
        """Single text-image pair (parity: cross_modal.py:34-86)."""
        return self.batch_compute([text], [image])[0]

    def batch_compute(
        self,
        texts: Sequence[str],
        images: Sequence[ImageLike],
        batch_size: Optional[int] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> List[CrossModalResult]:
        """Diagonal of the text×image cosine matrix per batch
        (parity: cross_modal.py:87-149)."""
        if len(texts) != len(images):
            raise ValueError("Number of texts and images must match")
        if not len(texts):
            return []
        if batch_size is not None:
            self.batch_size = int(batch_size)
        sims = self.batch_diagonal(texts, images, progress=progress)
        return [
            CrossModalResult(
                info_nce_score=float(s),
                text_to_image_sim=float(s),
                image_to_text_sim=float(s),
            )
            for s in sims
        ]

    def batch_diagonal(
        self,
        texts: Sequence[str],
        images: Sequence[ImageLike],
        progress: Optional[Callable[[int], None]] = None,
    ) -> np.ndarray:
        """Per-pair cosine as one ``[N]`` float32 array — the columnar-path
        variant of :meth:`batch_compute` (no per-doc result objects)."""
        t = self.encode_texts(texts)
        # Image encoding dominates the pair cost — report progress there.
        v = self.encode_images(images, progress=progress)
        # Embeddings are already normalized; dot product is cosine.
        return np.sum(t * v, axis=1).astype(np.float32)

    def similarity_matrix(
        self, texts: Sequence[str], images: Sequence[ImageLike]
    ) -> np.ndarray:
        """Full ``[N, M]`` text×image cosine matrix (one matmul)."""
        t = self.encode_texts(texts)
        v = self.encode_images(images)
        return t @ v.T

    def __call__(self, text: str, image: ImageLike) -> CrossModalResult:
        return self.compute_similarity(text, image)


__all__ = ["CrossModalDependency", "CrossModalResult"]
