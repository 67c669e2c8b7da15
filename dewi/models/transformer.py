"""Shared transformer building blocks for the DEWI signal backbones.

The reference consumes GPT-2 / ViT-MAE / CLIP through torch+transformers
(reference text_entropy.py:30-38, image_entropy.py:39-41, cross_modal.py:30).
Here the backbones are plain JAX functions over nested parameter dicts,
compiled by XLA: pre-LN blocks, bfloat16 compute with float32 parameters,
and static sequence lengths (estimators bucket/pad batches so jit traces
stay cached).

Every model is a frozen dataclass holding its config, with
``init(rng, *example_inputs) -> {"params": tree}`` and
``apply(variables, *inputs, method=None)``; the tree layout (``wte`` /
``encoder/block_i/attn/query/kernel`` / ...) is the one
:mod:`dewi.models.import_hf` writes and saved checkpoints hold.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

_lecun = jax.nn.initializers.lecun_normal()
_embed_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 258
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    max_len: int = 512
    dropout: float = 0.0  # inference-only framework: kept for completeness
    causal: bool = True
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    # Numerics knobs for weight-import parity with external checkpoints
    # (GPT-2: ln_eps=1e-5; CLIP: quick_gelu + 1e-5; ViT: gelu_exact + 1e-12).
    # Defaults reproduce this framework's native behavior exactly.
    ln_eps: float = 1e-6
    activation: str = "gelu"  # "gelu" (tanh approx) | "gelu_exact" | "quick_gelu"

    @property
    def compute_dtype(self) -> Any:
        return jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32


def activation_fn(name: str) -> Callable[[jax.Array], jax.Array]:
    if name == "gelu":
        return jax.nn.gelu  # tanh approximation (GPT-2's gelu_new)
    if name == "gelu_exact":
        return lambda x: jax.nn.gelu(x, approximate=False)
    if name == "quick_gelu":
        return lambda x: x * jax.nn.sigmoid(1.702 * x)
    raise ValueError(f"Unknown activation {name!r}")


class Module:
    """``init`` / ``apply`` over a ``{"params": tree}`` dict.

    Subclasses define ``init_params(rng, *example_inputs)`` and methods
    taking ``(self, params, *inputs)``; ``apply(..., method=m)`` accepts the
    method as a function, a bound method or its name."""

    def init_params(self, rng: jax.Array, *args: Any) -> dict:
        raise NotImplementedError

    def init(self, rng: jax.Array, *args: Any) -> dict:
        return {"params": self.init_params(rng, *args)}

    def apply(self, variables: dict, *args: Any,
              method: Any = None, **kwargs: Any) -> Any:
        fn = method if method is not None else type(self).__call__
        if isinstance(fn, str):
            fn = getattr(type(self), fn)
        fn = getattr(fn, "__func__", fn)
        return fn(self, variables["params"], *args, **kwargs)


# ---------------------------------------------------------------------------
# Layers: parameter builders + forwards
# ---------------------------------------------------------------------------


def init_dense(rng: jax.Array, d_in: int, d_out: int,
               use_bias: bool = True) -> dict:
    p = {"kernel": _lecun(rng, (d_in, d_out), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((d_out,), jnp.float32)
    return p


def dense(p: dict, x: jax.Array, dtype: Any) -> jax.Array:
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def init_embed(rng: jax.Array, n: int, d: int) -> dict:
    return {"embedding": _embed_init(rng, (n, d), jnp.float32)}


def init_layer_norm(d: int) -> dict:
    return {"scale": jnp.ones((d,), jnp.float32),
            "bias": jnp.zeros((d,), jnp.float32)}


def layer_norm(p: dict, x: jax.Array, eps: float) -> jax.Array:
    """LayerNorm computed (and returned) in float32."""
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def init_attention(rng: jax.Array, d: int, n_heads: int) -> dict:
    hd = d // n_heads
    kq, kk, kv, ko = jax.random.split(rng, 4)

    def proj(k: jax.Array) -> dict:
        return {"kernel": _lecun(k, (d, d), jnp.float32).reshape(d, n_heads, hd),
                "bias": jnp.zeros((n_heads, hd), jnp.float32)}

    return {
        "query": proj(kq), "key": proj(kk), "value": proj(kv),
        "out": {"kernel": _lecun(ko, (d, d), jnp.float32).reshape(n_heads, hd, d),
                "bias": jnp.zeros((d,), jnp.float32)},
    }


def attention(p: dict, x: jax.Array, mask: Optional[jax.Array],
              dtype: Any) -> jax.Array:
    """Multi-head self-attention; ``mask`` is boolean ``[B, 1, T, T]``."""

    def proj(name: str) -> jax.Array:
        return (jnp.einsum("btd,dhf->bthf", x.astype(dtype),
                           p[name]["kernel"].astype(dtype))
                + p[name]["bias"].astype(dtype))

    q, k, v = proj("query"), proj("key"), proj("value")
    q = q / jnp.sqrt(jnp.asarray(q.shape[-1], dtype))
    logits = jnp.einsum("bqhf,bkhf->bhqk", q, k)
    if mask is not None:
        logits = jnp.where(mask, logits, jnp.finfo(logits.dtype).min)
    w = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(dtype)
    o = jnp.einsum("bhqk,bkhf->bqhf", w, v)
    return (jnp.einsum("bqhf,hfd->bqd", o, p["out"]["kernel"].astype(dtype))
            + p["out"]["bias"].astype(dtype))


def make_attention_mask(
    pad_mask: jnp.ndarray, causal: bool
) -> jnp.ndarray:
    """Build a [B, 1, T, T] boolean attention mask from a [B, T] pad mask."""
    att = pad_mask[:, None, None, :] * jnp.ones_like(pad_mask)[:, None, :, None]
    if causal:
        t = pad_mask.shape[-1]
        tri = jnp.tril(jnp.ones((t, t), dtype=bool))
        att = att * tri[None, None, :, :]
    return att.astype(bool)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    cfg: TransformerConfig

    def init_params(self, rng: jax.Array, *args: Any) -> dict:
        k1, k2 = jax.random.split(rng)
        return {"fc_in": init_dense(k1, self.cfg.d_model, self.cfg.d_ff),
                "fc_out": init_dense(k2, self.cfg.d_ff, self.cfg.d_model)}

    def __call__(self, params: dict, x: jax.Array) -> jax.Array:
        dt = self.cfg.compute_dtype
        h = activation_fn(self.cfg.activation)(dense(params["fc_in"], x, dt))
        return dense(params["fc_out"], h, dt)


@dataclasses.dataclass(frozen=True)
class Block(Module):
    """Pre-LN transformer block: x + attn(ln(x)); x + mlp(ln(x))."""

    cfg: TransformerConfig

    def init_params(self, rng: jax.Array, *args: Any) -> dict:
        cfg = self.cfg
        ka, km = jax.random.split(rng)
        return {
            "ln_attn": init_layer_norm(cfg.d_model),
            "attn": init_attention(ka, cfg.d_model, cfg.n_heads),
            "ln_mlp": init_layer_norm(cfg.d_model),
            "mlp": MLP(cfg).init_params(km),
        }

    def __call__(self, params: dict, x: jax.Array,
                 attn_mask: Optional[jax.Array] = None) -> jax.Array:
        cfg = self.cfg
        h = layer_norm(params["ln_attn"], x, cfg.ln_eps)
        x = x + attention(params["attn"], h, attn_mask, cfg.compute_dtype)
        h = layer_norm(params["ln_mlp"], x, cfg.ln_eps)
        return x + MLP(cfg)(params["mlp"], h)


@dataclasses.dataclass(frozen=True)
class Encoder(Module):
    """A stack of blocks over already-embedded inputs, then a final LN."""

    cfg: TransformerConfig

    def init_params(self, rng: jax.Array, *args: Any) -> dict:
        keys = jax.random.split(rng, self.cfg.n_layers)
        p = {f"block_{i}": Block(self.cfg).init_params(keys[i])
             for i in range(self.cfg.n_layers)}
        p["ln_final"] = init_layer_norm(self.cfg.d_model)
        return p

    def __call__(self, params: dict, x: jax.Array,
                 pad_mask: Optional[jax.Array] = None) -> jax.Array:
        cfg = self.cfg
        attn_mask = None
        if pad_mask is not None or cfg.causal:
            if pad_mask is None:
                pad_mask = jnp.ones(x.shape[:2], dtype=bool)
            attn_mask = make_attention_mask(pad_mask.astype(bool), cfg.causal)
        for i in range(cfg.n_layers):
            x = Block(cfg)(params[f"block_{i}"], x, attn_mask)
        return layer_norm(params["ln_final"], x, cfg.ln_eps)


__all__ = [
    "TransformerConfig",
    "Module",
    "Encoder",
    "Block",
    "MLP",
    "make_attention_mask",
    "activation_fn",
    "attention",
    "dense",
    "init_dense",
    "init_embed",
    "init_layer_norm",
    "layer_norm",
]
