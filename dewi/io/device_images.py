"""Device-resident image corpora: upload once, every stage reads HBM.

Without this, each image-consuming stage of the columnar pipeline (MAE
entropy, CLIP vision tower, noise blur/skin) re-uploads the same decoded
corpus — 3x the host->device bytes of the corpus itself.  A uniform-size
uint8 corpus is instead placed on device ONCE and handed to the estimators
as :class:`DeviceImages`; their batch iterators then slice it device-side
(a [bs] view per dispatch) and, when a stage wants a different resolution,
resize on device with the same half-pixel bilinear weights as
``io.images.resize_f32`` — two small matmuls.

Rationale (goal: minimise host<->device transfers): the corpus crosses the
PCIe link once; per-stage traffic becomes device-memory reads.  The upload
is gated on a byte budget so 1M-image corpora don't evict the index from
device memory (``DEWI_DEVICE_IMAGES_MAX_BYTES``, default 4 GB);
over-budget or non-uint8 corpora keep the host batching path unchanged.

No reference counterpart — the reference decodes per stage on host
(reference image_entropy.py:39-49, pipelines.py:107-147).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any, Optional

import numpy as np

#: Upload gate: corpora above this stay host-side (HBM is the index's).
MAX_BYTES = int(os.environ.get("DEWI_DEVICE_IMAGES_MAX_BYTES", 4 << 30))


class DeviceImages:
    """A ``[N, H, W, 3]`` uint8 image corpus resident on one device.

    ``rows_at(lo, hi, size)`` returns a device batch at ``size`` px — a pure
    slice when ``size`` matches the stored resolution, else an on-device
    bilinear resize to f32 in [0, 1] (estimators' ``normalize_images``
    passes floats through, so both dtypes feed the towers unchanged).
    """

    def __init__(self, images: Any) -> None:
        import jax

        self.shape = tuple(images.shape)
        if len(self.shape) != 4 or self.shape[-1] != 3:
            raise ValueError(f"expected [N, H, W, 3], got {self.shape}")
        self.base = (
            images if isinstance(images, jax.Array)
            else jax.device_put(np.ascontiguousarray(images))
        )

    @property
    def size(self) -> int:
        return self.shape[1]

    def __len__(self) -> int:
        return self.shape[0]

    def gather(self, idx: Any) -> "DeviceImages":
        """Device-side row gather (no host round trip)."""
        import jax.numpy as jnp

        return DeviceImages(self.base[jnp.asarray(np.asarray(idx))])

    def rows_at(self, lo: int, hi: int, size: int) -> jax.Array:
        chunk = self.base[lo:hi]
        if (self.shape[1], self.shape[2]) == (size, size):
            return chunk
        return _resize_batch(chunk, size=size)


def _build_resize() -> Any:
    import jax
    import jax.numpy as jnp

    from ..ops.image_noise import _resize_matrix

    @partial(jax.jit, static_argnames=("size",))
    def fn(chunk: jax.Array, size: int) -> jax.Array:
        h, w = chunk.shape[1], chunk.shape[2]
        x = chunk.astype(jnp.float32)
        if chunk.dtype == jnp.uint8:
            x = x * (1.0 / 255.0)
        my = jnp.asarray(_resize_matrix(h, size))
        mx = jnp.asarray(_resize_matrix(w, size))
        x = jnp.einsum("oh,bhwc->bowc", my, x)
        return jnp.einsum("bowc,sw->bosc", x, mx)

    return fn


_RESIZE_CACHE = None


def _resize_batch(chunk: jax.Array, size: int) -> jax.Array:
    """Jitted ``[B, H, W, 3]`` -> f32 ``[B, size, size, 3]`` in [0,1]
    (bilinear, half-pixel centers — the resize_f32 weights as matmuls)."""
    global _RESIZE_CACHE
    if _RESIZE_CACHE is None:
        _RESIZE_CACHE = _build_resize()
    return _RESIZE_CACHE(chunk, size=size)


def device_images_or_none(images: Any) -> Optional[DeviceImages]:
    """Wrap a uniform uint8 ndarray corpus for device residency, or None.

    None (-> caller keeps the host path) when: not a 4D uint8 ndarray,
    over the :data:`MAX_BYTES` budget, or JAX has no device available.
    """
    if not (
        isinstance(images, np.ndarray)
        and images.ndim == 4
        and images.dtype == np.uint8
        and images.shape[-1] == 3
        and images.shape[0] > 0
    ):
        return None
    if images.nbytes > MAX_BYTES:
        return None
    try:
        return DeviceImages(images)
    except Exception:  # pragma: no cover - no device / OOM: host fallback
        return None


__all__ = ["DeviceImages", "device_images_or_none", "MAX_BYTES"]
