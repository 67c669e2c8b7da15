"""CLIP-style dual encoder: text tower + image tower + projection heads.

Replacement for the reference's ``openai/clip-vit-base-patch32``
usage (reference cross_modal.py:29-79, redundancy.py:24-39).  Text and image
embeddings come out L2-normalized so cross-modal similarity, redundancy
matrices, and the query-text encoder in search (SURVEY.md §2.4 item 6) are
plain matmuls on the caller side.
"""

from __future__ import annotations

from typing import Any

import dataclasses

import jax
import jax.numpy as jnp

from .transformer import (
    Encoder,
    Module,
    TransformerConfig,
    dense,
    init_dense,
    init_embed,
    init_layer_norm,
    layer_norm,
)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 258
    text_len: int = 77          # CLIP's max text length (reference cross_modal.py:55)
    d_text: int = 256
    text_heads: int = 4
    text_layers: int = 4
    image_size: int = 224
    patch_size: int = 32
    d_image: int = 256
    image_heads: int = 4
    image_layers: int = 4
    d_embed: int = 256
    dtype: str = "bfloat16"
    # Import-parity knobs (dewi.models.import_hf): OpenAI CLIP uses
    # quick_gelu, ln_eps=1e-5, a pre-encoder LayerNorm on the vision tower,
    # and explicit FF widths.  Defaults preserve native behavior (0 = 4*d).
    ln_eps: float = 1e-6
    activation: str = "gelu"
    image_pre_ln: bool = False
    text_ff: int = 0
    image_ff: int = 0

    def text_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size,
            d_model=self.d_text,
            n_heads=self.text_heads,
            n_layers=self.text_layers,
            d_ff=self.text_ff or 4 * self.d_text,
            max_len=self.text_len,
            causal=True,  # CLIP text towers are causal
            dtype=self.dtype,
            ln_eps=self.ln_eps,
            activation=self.activation,
        )

    def image_cfg(self) -> TransformerConfig:
        p = (self.image_size // self.patch_size) ** 2
        return TransformerConfig(
            vocab_size=1,
            d_model=self.d_image,
            n_heads=self.image_heads,
            n_layers=self.image_layers,
            d_ff=self.image_ff or 4 * self.d_image,
            max_len=p + 1,
            causal=False,
            dtype=self.dtype,
            ln_eps=self.ln_eps,
            activation=self.activation,
        )


def _normalize(x: jnp.ndarray) -> jnp.ndarray:
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@dataclasses.dataclass(frozen=True)
class CLIPTextTower(Module):
    cfg: CLIPConfig

    def init_params(self, rng: jax.Array, *args: Any) -> dict:
        cfg = self.cfg
        ks = jax.random.split(rng, 4)
        return {
            "wte": init_embed(ks[0], cfg.vocab_size, cfg.d_text),
            "wpe": init_embed(ks[1], cfg.text_len, cfg.d_text),
            "encoder": Encoder(cfg.text_cfg()).init_params(ks[2]),
            "text_proj": init_dense(ks[3], cfg.d_text, cfg.d_embed,
                                    use_bias=False),
        }

    def __call__(self, params: dict, ids: jnp.ndarray,
                 pad_mask: jnp.ndarray) -> jnp.ndarray:
        tc = self.cfg.text_cfg()
        dt = tc.compute_dtype
        x = (params["wte"]["embedding"].astype(dt)[ids]
             + params["wpe"]["embedding"][: ids.shape[1]].astype(dt)[None])
        x = Encoder(tc)(params["encoder"], x, pad_mask)
        # Pool at the last valid token (CLIP's EOT pooling).
        last = jnp.maximum(pad_mask.sum(axis=1).astype(jnp.int32) - 1, 0)
        pooled = jnp.take_along_axis(x, last[:, None, None], axis=1).squeeze(1)
        return _normalize(dense(params["text_proj"], pooled, jnp.float32))


@dataclasses.dataclass(frozen=True)
class CLIPImageTower(Module):
    cfg: CLIPConfig

    def init_params(self, rng: jax.Array, images: Any = None,
                    *args: Any) -> dict:
        cfg = self.cfg
        channels = 3 if images is None else int(images.shape[-1])
        n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1
        ks = jax.random.split(rng, 5)
        pos_init = jax.nn.initializers.normal(0.02)
        p = {
            "patch_embed": init_dense(
                ks[0], cfg.patch_size * cfg.patch_size * channels, cfg.d_image
            ),
            "cls": pos_init(ks[1], (1, 1, cfg.d_image), jnp.float32),
            "pos": pos_init(ks[2], (n_tok, cfg.d_image), jnp.float32),
            "encoder": Encoder(cfg.image_cfg()).init_params(ks[3]),
            "image_proj": init_dense(ks[4], cfg.d_image, cfg.d_embed,
                                     use_bias=False),
        }
        if cfg.image_pre_ln:
            p["pre_ln"] = init_layer_norm(cfg.d_image)
        return p

    def __call__(self, params: dict, images: jnp.ndarray) -> jnp.ndarray:
        from .mae import patchify

        cfg = self.cfg
        ic = cfg.image_cfg()
        dt = ic.compute_dtype
        patches = patchify(images.astype(jnp.float32), cfg.patch_size)
        x = dense(params["patch_embed"], patches, dt)
        cls = jnp.broadcast_to(params["cls"].astype(x.dtype),
                               (x.shape[0], 1, cfg.d_image))
        x = jnp.concatenate([cls, x], axis=1)
        x = x + params["pos"][None, :, :].astype(x.dtype)
        if cfg.image_pre_ln:
            # HF CLIP vision towers LayerNorm embeddings before the encoder.
            x = layer_norm(params["pre_ln"], x, cfg.ln_eps)
        x = Encoder(ic)(params["encoder"], x)
        return _normalize(dense(params["image_proj"], x[:, 0, :], jnp.float32))


@dataclasses.dataclass(frozen=True)
class CLIPDualEncoder(Module):
    """Both towers under one param tree; ``method=`` selects a tower."""

    cfg: CLIPConfig

    def init_params(self, rng: jax.Array, ids: Any = None,
                    pad_mask: Any = None, images: Any = None) -> dict:
        kt, ki = jax.random.split(rng)
        return {
            "text_tower": CLIPTextTower(self.cfg).init_params(kt),
            "image_tower": CLIPImageTower(self.cfg).init_params(ki, images),
            "logit_scale": jnp.asarray(jnp.log(1 / 0.07), jnp.float32),
        }

    def encode_text(self, params: dict, ids: jnp.ndarray,
                    pad_mask: jnp.ndarray) -> jnp.ndarray:
        return CLIPTextTower(self.cfg)(params["text_tower"], ids, pad_mask)

    def encode_image(self, params: dict, images: jnp.ndarray) -> jnp.ndarray:
        return CLIPImageTower(self.cfg)(params["image_tower"], images)

    def __call__(self, params: dict, ids: jnp.ndarray, pad_mask: jnp.ndarray,
                 images: jnp.ndarray) -> Any:
        t = self.encode_text(params, ids, pad_mask)
        v = self.encode_image(params, images)
        return t, v, params["logit_scale"]


__all__ = ["CLIPConfig", "CLIPDualEncoder", "CLIPTextTower", "CLIPImageTower"]
