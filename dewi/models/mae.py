"""ViT-MAE for image-entropy estimation (masked reconstruction error).

Replacement for the reference's ``ViTMAEForPreTraining`` loss path
(reference image_entropy.py:39-74): patchify, mask a fixed 75% of patches,
encode the visible set, decode with mask tokens, and report per-image MSE on
the masked patches.  All shapes are static under jit — masking is done with
an ``argsort`` of uniform noise and fixed visible/masked counts, so the same
trace serves every image batch (no recompiles, no dynamic gathers).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from .transformer import Encoder, Module, TransformerConfig, dense, init_dense


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    dec_d_model: int = 128
    dec_n_heads: int = 4
    dec_n_layers: int = 2
    dec_d_ff: int = 512
    mask_ratio: float = 0.75
    norm_pix: bool = True
    dtype: str = "bfloat16"
    # Import-parity knobs (dewi.models.import_hf): HF ViT-MAE prepends a
    # CLS token in both encoder and decoder, uses exact gelu and ln_eps=1e-12.
    # Defaults preserve native behavior.
    ln_eps: float = 1e-6
    activation: str = "gelu"
    use_cls: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_visible(self) -> int:
        return max(1, round(self.num_patches * (1.0 - self.mask_ratio)))

    def encoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1,
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_layers=self.n_layers,
            d_ff=self.d_ff,
            max_len=self.num_patches + 1,
            causal=False,
            dtype=self.dtype,
            ln_eps=self.ln_eps,
            activation=self.activation,
        )

    def decoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1,
            d_model=self.dec_d_model,
            n_heads=self.dec_n_heads,
            n_layers=self.dec_n_layers,
            d_ff=self.dec_d_ff,
            max_len=self.num_patches + 1,
            causal=False,
            dtype=self.dtype,
            ln_eps=self.ln_eps,
            activation=self.activation,
        )


def patchify(images: jnp.ndarray, patch: int) -> jnp.ndarray:
    """``[B, H, W, C] -> [B, P, patch*patch*C]`` row-major patch grid."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


@dataclasses.dataclass(frozen=True)
class ViTMAE(Module):
    """Masked autoencoder.

    ``patch_losses`` returns per-patch reconstruction MSE ``[B, P]`` plus the
    mask of reconstructed (hidden) patches; ``__call__`` reduces that to the
    per-image masked-patch MSE the reference loss path reports
    (image_entropy.py:66-68).  Exposing the per-patch losses lets the
    pipeline derive real ``hi_q90`` quantiles — the reference promised them
    (pipelines.py:121-128) but its estimator only ever returned a scalar
    (SURVEY.md §2.4 item 3).
    """

    cfg: MAEConfig

    def init_params(self, rng: jax.Array, images: Optional[jax.Array] = None,
                    *args: Any) -> dict:
        cfg = self.cfg
        channels = 3 if images is None else int(images.shape[-1])
        n_pos = cfg.num_patches + 1 if cfg.use_cls else cfg.num_patches
        ks = jax.random.split(rng, 8)
        pos_init = jax.nn.initializers.normal(0.02)
        p = {
            "patch_embed": init_dense(
                ks[0], cfg.patch_size * cfg.patch_size * channels, cfg.d_model
            ),
            "enc_pos": pos_init(ks[1], (n_pos, cfg.d_model), jnp.float32),
            "encoder": Encoder(cfg.encoder_cfg()).init_params(ks[2]),
            "dec_embed": init_dense(ks[3], cfg.d_model, cfg.dec_d_model),
            "mask_token": pos_init(ks[4], (1, 1, cfg.dec_d_model), jnp.float32),
            "dec_pos": pos_init(ks[5], (n_pos, cfg.dec_d_model), jnp.float32),
            "decoder": Encoder(cfg.decoder_cfg()).init_params(ks[6]),
            "dec_pred": init_dense(
                ks[7], cfg.dec_d_model,
                cfg.patch_size * cfg.patch_size * channels,
            ),
        }
        if cfg.use_cls:
            p["cls"] = pos_init(jax.random.fold_in(rng, 1),
                                (1, 1, cfg.d_model), jnp.float32)
        return p

    def __call__(
        self,
        params: dict,
        images: jnp.ndarray,
        rng: Optional[jax.Array] = None,
        noise: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        per_patch, mask = self.patch_losses(params, images, rng, noise)
        return jnp.sum(per_patch * mask, axis=1) / jnp.maximum(
            jnp.sum(mask, axis=1), 1.0
        )

    def patch_losses(
        self,
        params: dict,
        images: jnp.ndarray,
        rng: Optional[jax.Array] = None,
        noise: Optional[jnp.ndarray] = None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """``noise`` overrides the masking randomness (shape ``[B, P]``) —
        used for HF import-parity tests and deterministic replays."""
        cfg = self.cfg
        dt = cfg.encoder_cfg().compute_dtype
        p = cfg.num_patches
        v = cfg.num_visible

        patches = patchify(images.astype(jnp.float32), cfg.patch_size)
        target = patches
        if cfg.norm_pix:
            mu = patches.mean(axis=-1, keepdims=True)
            # Unbiased variance (ddof=1) matches HF ViT-MAE's torch.var
            # normalization exactly (modeling_vit_mae forward_loss).
            var = patches.var(axis=-1, keepdims=True, ddof=1)
            target = (patches - mu) / jnp.sqrt(var + 1e-6)

        # Random masking with static counts (fixed V visible, P-V masked).
        if noise is None:
            noise = jax.random.uniform(rng, (images.shape[0], p))
        ids_shuffle = jnp.argsort(noise, axis=1)          # [B, P]
        ids_restore = jnp.argsort(ids_shuffle, axis=1)    # [B, P]
        ids_keep = ids_shuffle[:, :v]

        x = dense(params["patch_embed"], patches, dt)
        enc_pos = params["enc_pos"]
        grid_pos = enc_pos[1:] if cfg.use_cls else enc_pos
        x = x + grid_pos[None, :, :].astype(dt)
        x_vis = jnp.take_along_axis(x, ids_keep[:, :, None], axis=1)  # [B, V, D]
        if cfg.use_cls:
            # HF ViT-MAE: CLS token (+ its position) prepended to the visible
            # set after masking (modeling_vit_mae ViTMAEEmbeddings.forward).
            cls_tok = (params["cls"] + enc_pos[None, :1, :]).astype(x_vis.dtype)
            x_vis = jnp.concatenate(
                [jnp.broadcast_to(cls_tok, (x_vis.shape[0], 1, cfg.d_model)),
                 x_vis], axis=1,
            )
        x_vis = Encoder(cfg.encoder_cfg())(params["encoder"], x_vis)

        # Decoder: visible tokens + learned mask tokens, unshuffled to grid order.
        y = dense(params["dec_embed"], x_vis, dt)
        masked = jnp.broadcast_to(
            params["mask_token"].astype(y.dtype),
            (y.shape[0], p - v, cfg.dec_d_model),
        )
        y_cls = None
        if cfg.use_cls:
            y_cls, y = y[:, :1, :], y[:, 1:, :]
        y_full = jnp.concatenate([y, masked], axis=1)                  # [B, P, Dd]
        y_full = jnp.take_along_axis(y_full, ids_restore[:, :, None], axis=1)
        if cfg.use_cls:
            y_full = jnp.concatenate([y_cls, y_full], axis=1)          # [B, P+1, Dd]
        y_full = y_full + params["dec_pos"][None, :, :].astype(y_full.dtype)
        y_full = Encoder(cfg.decoder_cfg())(params["decoder"], y_full)
        pred = dense(params["dec_pred"], y_full, jnp.float32)
        if cfg.use_cls:
            pred = pred[:, 1:, :]

        # Per-image MSE over masked patches only (reference loss semantics).
        mask = jnp.take_along_axis(
            jnp.concatenate(
                [jnp.zeros((images.shape[0], v)), jnp.ones((images.shape[0], p - v))],
                axis=1,
            ),
            ids_restore,
            axis=1,
        )
        per_patch = jnp.mean((pred - target) ** 2, axis=-1)            # [B, P]
        return per_patch, mask


def pixel_entropy_proxy(images: jnp.ndarray) -> jnp.ndarray:
    """Model-free fallback: luma ``var / mean^2`` per image.

    Parity with the reference's no-model fallback (reference
    image_entropy.py:51-54), vectorized over the batch.
    """
    images = images.astype(jnp.float32)
    if images.ndim == 4 and images.shape[-1] == 3:
        luma = (
            0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
        )
    else:
        luma = images.reshape(images.shape[0], images.shape[1], -1).mean(-1)
    flat = luma.reshape(luma.shape[0], -1)
    return flat.var(axis=1) / (flat.mean(axis=1) ** 2 + 1e-8)


def pixel_patch_proxy(images: jnp.ndarray, patch: int = 8) -> jnp.ndarray:
    """Per-patch ``var/mean^2`` proxy ``[B, P]`` (patch-level analogue of
    :func:`pixel_entropy_proxy`, so the fallback path also yields quantiles)."""
    images = images.astype(jnp.float32)
    if images.ndim == 4 and images.shape[-1] == 3:
        luma = (
            0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
        )
    else:
        luma = images.reshape(images.shape[0], images.shape[1], -1).mean(-1)
    b, h, w = luma.shape
    gh, gw = h // patch, w // patch
    x = luma[:, : gh * patch, : gw * patch]
    x = x.reshape(b, gh, patch, gw, patch).transpose(0, 1, 3, 2, 4)
    x = x.reshape(b, gh * gw, patch * patch)
    return x.var(axis=2) / (x.mean(axis=2) ** 2 + 1e-8)


__all__ = [
    "MAEConfig",
    "ViTMAE",
    "patchify",
    "pixel_entropy_proxy",
    "pixel_patch_proxy",
]
