"""Batched image-noise kernels: blur Laplacian + skin-fraction NSFW.

The scalar path (signals/noise.py: ``blur_score`` / ``skin_fraction_risk``)
decodes, resizes, and reduces each image individually on the host, which
makes noise the largest stage of an image pipeline whose forwards run on
the device.  Both heuristics are linear
or elementwise math, so the batched path runs them as ONE jitted XLA
program over the whole image batch:

* blur — luma is a per-pixel dot with the BT.601 weights; the bilinear
  upscale to ``BLUR_SIZE`` is two matmuls with the same half-pixel-center
  weights as :func:`dewi.io.images.resize_f32` (cheap matmuls); the
  5-point Laplacian and its variance are fused elementwise/reduce ops.
* skin — YCbCr threshold gate + mean at 64 px, elementwise.

Semantics vs the scalar path: identical math in f32 end to end.  The scalar
path quantizes the PIL-resized image to uint8 before the luma dot, so
batched blur scores differ by the rounding noise of that quantization
(|Δ| ≲ 0.02 in rescaled units against a 0.25 threshold, measured in
tests/test_signals.py::test_batched_matches_scalar_blur); when the input is
already at target size the two paths agree exactly.

No reference counterpart — the reference promised ``blur_threshold``
(config.py:36) but never implemented a detector; the batched design here is
DEWI's own (SURVEY.md §2.4 item 5 follow-on).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

#: BT.601 luma weights (matches signals/noise.py blur_score).
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


@lru_cache(maxsize=32)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """``[dst, src]`` bilinear interpolation matrix with half-pixel centers —
    row ``i`` holds the source weights of output pixel ``i`` (exactly the
    weights of :func:`dewi.io.images.resize_f32`)."""
    y = (np.arange(dst, dtype=np.float64) + 0.5) * src / dst - 0.5
    y0 = np.clip(np.floor(y).astype(np.int64), 0, src - 1)
    y1 = np.minimum(y0 + 1, src - 1)
    wy = np.clip(y - y0, 0.0, 1.0)
    m = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    np.add.at(m, (rows, y0), (1.0 - wy).astype(np.float32))
    np.add.at(m, (rows, y1), wy.astype(np.float32))
    return m


@partial(jax.jit, static_argnames=("blur_size", "skin_size"))
def _image_noise_kernel(
    imgs: jax.Array,  # [B, H, W, 3] uint8
    blur_size: int,
    skin_size: int,
) -> tuple[jax.Array, jax.Array]:
    """Returns ``(lap_var [B] f32, skin_frac [B] f32)`` for a uint8 batch."""
    h, w = imgs.shape[1], imgs.shape[2]
    x = imgs.astype(jnp.float32) / 255.0                      # [B, H, W, 3]

    # -- blur: luma -> bilinear upscale (two matmuls) -> Laplacian -> var --
    luma = x @ jnp.asarray(_LUMA)                             # [B, H, W]
    if (h, w) != (blur_size, blur_size):
        my = jnp.asarray(_resize_matrix(h, blur_size))        # [S, H]
        mx = jnp.asarray(_resize_matrix(w, blur_size))        # [S, W]
        up = jnp.einsum("oh,bhw->bow", my, luma)
        up = jnp.einsum("bow,sw->bos", up, mx)                # [B, S, S]
    else:
        up = luma
    lap = (
        -4.0 * up[:, 1:-1, 1:-1]
        + up[:, :-2, 1:-1]
        + up[:, 2:, 1:-1]
        + up[:, 1:-1, :-2]
        + up[:, 1:-1, 2:]
    )
    lap_var = jnp.var(lap, axis=(1, 2)) * 1e3                 # rescale, parity

    # -- skin fraction at skin_size (YCbCr gate, signals/noise.py) --------
    if (h, w) != (skin_size, skin_size):
        sy = jnp.asarray(_resize_matrix(h, skin_size))
        sx = jnp.asarray(_resize_matrix(w, skin_size))
        xs = jnp.einsum("oh,bhwc->bowc", sy, x)
        xs = jnp.einsum("bowc,sw->bosc", xs, sx)              # [B, s, s, 3]
    else:
        xs = x
    r, g, b = xs[..., 0], xs[..., 1], xs[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.564 * (b - y) + 0.5
    cr = 0.713 * (r - y) + 0.5
    skin = (
        (cb > 0.30) & (cb < 0.50) & (cr > 0.52) & (cr < 0.68) & (y > 0.15)
    )
    return lap_var, jnp.mean(skin.astype(jnp.float32), axis=(1, 2))


#: Per-dispatch batch; chunks are zero-padded to a multiple of this so each
#: (H, W) image shape compiles exactly two programs (full + last chunk pad).
CHUNK = 2048


def batched_image_noise(
    imgs: np.ndarray,
    blur_size: int = 224,
    skin_size: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Device-batched ``(blur_score [B], skin_frac [B])`` for a uniform
    ``[B, H, W, 3]`` uint8 array — host ndarray or device-resident
    ``jax.Array`` (DeviceImages corpus: zero re-upload).  Chunked at
    :data:`CHUNK` images per dispatch (bounds the transfer buffer; the last
    chunk pads to the full chunk size so every dispatch hits the same
    compiled program)."""
    from ..utils.deferred import DeferredFetcher

    on_device = isinstance(imgs, jax.Array)
    if not on_device:
        imgs = np.ascontiguousarray(imgs)
    n = imgs.shape[0]
    xp = jnp if on_device else np
    # Deferred fetches: all chunks dispatch back to back; ONE host round
    # trip returns every chunk's [b] aggregates (utils/deferred.py).
    d_blur = DeferredFetcher()
    d_skin = DeferredFetcher()
    for s in range(0, n, CHUNK):
        part = imgs[s : s + CHUNK]
        b = part.shape[0]
        if b < CHUNK:
            # Large corpora pad the tail to CHUNK (re-hits the full-chunk
            # program); small/irregular batches (per-shape noise groups
            # stack arbitrary counts) pad to the next power of two so the
            # trace count stays O(log CHUNK), not one per distinct size.
            target = CHUNK if n > CHUNK else max(8, 1 << (b - 1).bit_length())
            if target > b:
                pad = xp.zeros((target - b, *imgs.shape[1:]), imgs.dtype)
                part = xp.concatenate([part, pad], axis=0)
        lv, sf = _image_noise_kernel(
            jnp.asarray(part), blur_size=blur_size, skin_size=skin_size
        )
        cost = 0 if on_device else int(part.nbytes)
        d_blur.append(lv, keep=b, cost=cost)
        d_skin.append(sf, keep=b)
    return (
        d_blur.result().astype(np.float32),
        d_skin.result().astype(np.float32),
    )


__all__ = ["batched_image_noise", "CHUNK"]
