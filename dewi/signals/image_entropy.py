"""Image entropy via ViT-MAE masked-reconstruction error.

API parity with the reference estimator (reference image_entropy.py:19-74):
``score(image) -> float`` (MSE, non-negative) with a model-free pixel
``var/mean^2`` proxy fallback (image_entropy.py:51-54).  Additions:
``batch_compute`` scores whole padded ``[B, H, W, 3]`` batches in one jitted
forward (the reference has no image batch path at all — SURVEY.md §2.4
item 3), masking uses static visible/masked counts so one trace serves every
batch, and ingestion runs through the prefetching uint8 loader
(:mod:`dewi.io`): host threads decode batch N+1 while the device scores
batch N, images cross PCIe as uint8 (4× less transfer than f32), and the
``/255`` normalization happens on device inside the jitted forward.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..io.images import decode_image_uint8
from ..models.mae import pixel_entropy_proxy, pixel_patch_proxy
from ..models.registry import init_mae, mae_config, maybe_load
from ..ops.robust import masked_mean_and_quantiles

logger = logging.getLogger(__name__)

try:  # Optional dependency, used only to decode/resize PIL inputs.
    from PIL import Image

    _HAS_PIL = True
except Exception:  # pragma: no cover
    Image = None  # type: ignore
    _HAS_PIL = False

ImageLike = Union["Image.Image", np.ndarray, str]


def normalize_images(images: jax.Array) -> jax.Array:
    """uint8 → f32 in [0,1] inside jit; float inputs pass through.

    The dtype branch resolves at trace time, so uint8 and f32 callers each
    get their own compiled program with no runtime cost.
    """
    if images.dtype == jnp.uint8:
        return images.astype(jnp.float32) * (1.0 / 255.0)
    return images.astype(jnp.float32)


def to_image_array(image: ImageLike, size: int) -> np.ndarray:
    """Decode/resize any supported input to ``[size, size, 3]`` f32 in [0,1].

    Float arrays already at the target size pass through without a uint8
    round-trip; everything else routes through the uint8 decoder (PIL draft
    mode for JPEG paths, threadable, see :mod:`dewi.io.images`).
    """
    if (
        isinstance(image, np.ndarray)
        and image.ndim in (2, 3)
        and image.dtype != np.uint8
        and (image.ndim == 2 or image.shape[-1] == 3)
    ):
        # Float-valued inputs stay in float end to end: bilinear resize in
        # f32 (no uint8 quantization) keeps synthetic [0,1] arrays at
        # non-target resolutions bit-faithful to the pre-resize signal.
        arr = np.asarray(image, dtype=np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.size and float(arr.max()) > 1.5:  # uint8-range floats
            arr = arr / 255.0
        from ..io.images import resize_f32

        return resize_f32(arr, size)
    return decode_image_uint8(image, size).astype(np.float32) / 255.0


class ImageEntropyEstimator:
    """MAE reconstruction-loss estimator with batched jitted inference.

    Accepts the union of the reference ctor (image_entropy.py:26-33) and the
    pipeline's kwargs (pipelines.py:56-61) — SURVEY.md §2.4 item 1.  Pass
    ``model_name="pixel"`` to force the variance-proxy fallback.

    ``images`` arguments accept mixed path/PIL/array sequences (decoded by
    the threaded loader) or a pre-decoded ``[N, H, W, 3]`` array at the
    estimator's resolution (e.g. :meth:`dewi.io.ImageCache.at`), which
    skips decoding entirely.
    """

    def __init__(
        self,
        model_name: str = "small",
        device: Optional[str] = None,
        mask_ratio: float = 0.75,
        patch_size: Optional[int] = None,
        image_size: Optional[int] = None,
        batch_size: int = 64,
        checkpoint: Optional[str] = None,
        seed: int = 0,
        io_threads: int = 4,
        mesh: Any = None,
        **_: object,
    ) -> None:
        del device
        self.batch_size = int(batch_size)
        self.mask_ratio = float(mask_ratio)
        self.io_threads = int(io_threads)
        self.superbatch = 8
        # Data-parallel mesh execution: params replicate, image batches
        # shard over the 'data' axis (parallel/signals.py) — replaces the
        # reference's single-GPU forward (image_entropy.py:56-74).
        self._dp = None
        if mesh is not None:
            from ..parallel.signals import DataParallel

            self._dp = DataParallel(mesh)
            self.batch_size = self._dp.round_batch(self.batch_size)
        if model_name in ("pixel", "none", "proxy"):
            self.model = None
            self.params = None
            self.cfg = None
            self.image_size = int(image_size or 224)
            return
        from ..models.import_hf import sidecar_config

        side = sidecar_config(checkpoint)
        if side is not None:
            import dataclasses

            from ..models.mae import MAEConfig

            # Sidecar defines the architecture; mask_ratio stays tunable.
            self.cfg = dataclasses.replace(
                MAEConfig(**side["config"]), mask_ratio=self.mask_ratio
            )
        else:
            over = {"mask_ratio": self.mask_ratio}
            if patch_size:
                over["patch_size"] = int(patch_size)
            if image_size:
                over["image_size"] = int(image_size)
            self.cfg = mae_config(model_name, **over)
        self.image_size = self.cfg.image_size
        self.model, params = init_mae(self.cfg, seed=seed)
        self.params = maybe_load(params, checkpoint)
        if self._dp is not None:
            self.params = self._dp.replicate(self.params)

        @jax.jit
        def _losses(params: Any, images: jax.Array,
                    rng: jax.Array) -> jax.Array:
            return self.model.apply(params, normalize_images(images), rng)

        self._apply = _losses

        @jax.jit
        def _stats(params: Any, images: jax.Array,
                   rng: jax.Array) -> Any:
            per_patch, mask = self.model.apply(
                params, normalize_images(images), rng,
                method=self.model.patch_losses,
            )
            mean, qs = masked_mean_and_quantiles(
                per_patch, mask, jnp.asarray([0.9], jnp.float32)
            )
            return mean, qs[:, 0]

        self._stats = _stats

        # Superbatch: S batches per dispatch (see text_entropy — host
        # launches per corpus drop by S).
        @jax.jit
        def _stats_super(params: Any, images4: jax.Array,
                         rngs: jax.Array) -> Any:
            return jax.lax.map(
                lambda xr: _stats(params, xr[0], xr[1]), (images4, rngs)
            )

        self._stats_super = _stats_super

    def _dev(self, arr: Any, batch_axis: int = 0) -> Any:
        """Batch placement: plain device array, or sharded over the mesh's
        data axis when this estimator runs data-parallel."""
        if self._dp is None:
            return jnp.asarray(arr)
        return self._dp.put(arr, batch_axis)

    # -- input batching -------------------------------------------------------

    def _padded_batches(
        self, images: Sequence[ImageLike], bs: int
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield ``(batch [bs, S, S, 3], pad)``: slices of a pre-decoded
        corpus array, or prefetch-decoded uint8 batches for everything else."""
        from ..io.images import iter_corpus_batches

        yield from iter_corpus_batches(
            images, self.image_size, bs,
            threads=self.io_threads, depth=max(2, self.superbatch),
        )

    # -- public API ---------------------------------------------------------

    def score(self, image: ImageLike, seed: int = 0) -> float:
        """Single-image reconstruction MSE (parity: image_entropy.py:51-74).

        The random patch mask is seeded (deterministic), unlike the
        reference's unseeded ``torch.randperm`` — reproducibility is part of
        this framework's contract.
        """
        return self.batch_compute([image], seed=seed)[0]

    def batch_compute(
        self, images: Sequence[ImageLike], seed: int = 0,
        batch_size: Optional[int] = None,
    ) -> List[float]:
        if not len(images):
            return []
        bs = int(batch_size or self.batch_size)
        out: List[float] = []
        base_key = jax.random.PRNGKey(seed)
        for b, (chunk, pad) in enumerate(self._padded_batches(images, bs)):
            if self.model is None:
                arr = to_f32_batch(chunk)[: bs - pad]
                out.extend(
                    float(v) for v in np.asarray(pixel_entropy_proxy(arr))
                )
                continue
            losses = self._apply(
                self.params, self._dev(chunk),
                jax.random.fold_in(base_key, b * bs),
            )
            out.extend(float(v) for v in np.asarray(losses)[: bs - pad])
        return out

    def batch_compute_stats(
        self, images: Sequence[ImageLike], seed: int = 0,
        batch_size: Optional[int] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> tuple:
        """Per-image ``(mean, q90)`` of patch reconstruction error.

        The pipeline's ``hi_mean``/``hi_q90`` source — the reference promised
        image quantiles (pipelines.py:121-128) its scalar estimator could
        never provide (SURVEY.md §2.4 item 3).
        """
        if not len(images):
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        bs = int(batch_size or self.batch_size)
        means: List[float] = []
        q90s: List[float] = []
        base_key = jax.random.PRNGKey(seed)

        if self.model is None:
            for chunk, pad in self._padded_batches(images, bs):
                per_patch = np.asarray(
                    pixel_patch_proxy(jnp.asarray(to_f32_batch(chunk)))
                )[: bs - pad]
                means.extend(per_patch.mean(axis=1).tolist())
                q90s.extend(np.quantile(per_patch, 0.9, axis=1).tolist())
                if progress is not None:
                    progress(bs - pad)
            return (
                np.asarray(means, np.float32), np.asarray(q90s, np.float32)
            )

        # Group S prefetched batches per dispatch; the loader decodes ahead
        # on host threads while the previous supergroup runs on device.
        # Results stay on device (DeferredFetcher): one host fetch at the
        # end of the corpus instead of a blocking round trip per supergroup.
        from ..utils.deferred import DeferredFetcher

        S = max(1, int(self.superbatch))
        group: List[Tuple[np.ndarray, int]] = []
        ordinal = 0
        d_mean = DeferredFetcher()
        d_q90 = DeferredFetcher()

        def flush_group() -> None:
            nonlocal ordinal
            if not group:
                return
            pads = [pad for _, pad in group]
            if len(group) == S:
                chunks = [c for c, _ in group]
                # Device-resident chunks (DeviceImages corpus) stack on
                # device; np.stack would silently round-trip to host.
                images4 = (
                    jnp.stack(chunks) if isinstance(chunks[0], jax.Array)
                    else np.stack(chunks)
                )
                rngs = jnp.stack([
                    jax.random.fold_in(base_key, (ordinal + i) * bs)
                    for i in range(S)
                ])
                m3, q3 = self._stats_super(
                    self.params, self._dev(images4, 1), rngs
                )
                in_bytes = (
                    0 if isinstance(images4, jax.Array) else images4.nbytes
                )
                for i, pad in enumerate(pads):
                    d_mean.append(m3[i], keep=bs - pad,
                                  cost=in_bytes if i == 0 else 0)
                    d_q90.append(q3[i], keep=bs - pad)
            else:
                for i, (chunk, pad) in enumerate(group):
                    m, q = self._stats(
                        self.params, self._dev(chunk),
                        jax.random.fold_in(base_key, (ordinal + i) * bs),
                    )
                    in_bytes = (
                        0 if isinstance(chunk, jax.Array) else chunk.nbytes
                    )
                    d_mean.append(m, keep=bs - pad, cost=in_bytes)
                    d_q90.append(q, keep=bs - pad)
            if progress is not None:
                progress(sum(bs - pad for pad in pads))
            ordinal += len(group)
            group.clear()

        for chunk, pad in self._padded_batches(images, bs):
            group.append((chunk, pad))
            if len(group) == S:
                flush_group()
        flush_group()
        return (
            d_mean.result().astype(np.float32),
            d_q90.result().astype(np.float32),
        )

    def __call__(self, image: ImageLike, **kwargs: Any) -> float:
        return self.score(image, **kwargs)


def to_f32_batch(batch: np.ndarray) -> np.ndarray:
    """Host-side uint8 → f32 [0,1] for the model-free proxy paths.

    Float batches in uint8 range scale down too (same convention as
    ``to_image_array``)."""
    if isinstance(batch, jax.Array):
        # Device chunk (DeviceImages): stay on device.  uint8 scales; the
        # on-device resize already emits f32 in [0, 1].
        if batch.dtype == jnp.uint8:
            return batch.astype(jnp.float32) * (1.0 / 255.0)
        return batch.astype(jnp.float32)
    if batch.dtype == np.uint8:
        return batch.astype(np.float32) / 255.0
    b = batch.astype(np.float32)
    if b.size and float(b.max()) > 1.5:
        b = b / 255.0
    return b


__all__ = [
    "ImageEntropyEstimator",
    "normalize_images",
    "to_f32_batch",
    "to_image_array",
    "ImageLike",
]
