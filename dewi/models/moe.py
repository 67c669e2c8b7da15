"""Mixture-of-experts FFN (Switch-style top-1) with expert parallelism.

No reference counterpart (the reference's backbones are dense torch models,
SURVEY.md §2.2); this exists so in-repo backbone pretraining can scale
parameter count without scaling per-token FLOPs, with experts sharded over
a mesh axis (expert parallelism).

Design choices:

* **Dense einsum dispatch** — tokens are routed into per-expert capacity
  buffers with one-hot einsums (`nec,nd->ecd`), not gather/scatter: the
  dispatch/combine become matmuls and XLA turns the sharded expert
  einsum into the all-to-all collective pattern on its own.
* **Static capacity** — ``capacity = ceil(tokens/experts) * capacity_factor``
  is shape-static (jit-stable); overflow tokens fall through the residual
  (standard Switch behavior).
* **Stacked expert weights** — ``[E, d, ff]`` / ``[E, ff, d]`` leaves; shard
  the leading axis over the mesh's model/expert axis
  (:func:`shard_expert_params`) and each device materializes only its own
  experts.
* **Load-balance aux loss** (Switch: ``E * sum(f_e * p_e)``) is returned via
  a module sow so the training loop can weight it.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import jax
import jax.numpy as jnp
from flax import linen as nn

from .transformer import TransformerConfig, activation_fn, make_attention_mask


class MoEMLP(nn.Module):
    """Top-1 routed FFN: each token is processed by one of ``n_experts``."""

    cfg: TransformerConfig
    n_experts: int = 4
    capacity_factor: float = 1.25

    @nn.compact
    def __call__(
        self, x: jnp.ndarray, pad_mask: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        cfg = self.cfg
        dt = cfg.compute_dtype
        e = self.n_experts
        b, t, d = x.shape
        n = b * t
        cap = max(1, int(math.ceil(n / e * self.capacity_factor)))

        xf = x.reshape(n, d)
        # Router in f32 for numerically stable softmax.
        logits = nn.Dense(e, dtype=jnp.float32, name="router")(
            xf.astype(jnp.float32)
        )
        probs = jax.nn.softmax(logits, axis=-1)                  # [N, E]
        gate = jnp.max(probs, axis=-1)                           # [N]
        expert = jnp.argmax(probs, axis=-1)                      # [N]

        onehot = jax.nn.one_hot(expert, e, dtype=jnp.float32)    # [N, E]
        if pad_mask is not None:
            # Padding tokens neither consume expert capacity nor count in
            # the load-balance statistics — otherwise a mostly-padded batch
            # "balances" identical PAD embeddings while real-token balance
            # goes unconstrained.
            live = pad_mask.reshape(n).astype(jnp.float32)
            onehot = onehot * live[:, None]
            probs = probs * live[:, None]
        # Position of each token within its expert's buffer (0-based).
        pos = jnp.cumsum(onehot, axis=0) * onehot - onehot       # [N, E]
        keep = (pos < cap) * onehot                              # [N, E]
        # Dispatch tensor [N, E, C]: one-hot over buffer slots.
        slot = jax.nn.one_hot(pos.astype(jnp.int32), cap,
                              dtype=jnp.float32)                 # [N, E, C]
        dispatch = slot * keep[..., None]                        # [N, E, C]
        combine = dispatch * gate[:, None, None]                 # [N, E, C]

        # Gather tokens into expert buffers: [E, C, D] (a matmul).
        expert_in = jnp.einsum("nec,nd->ecd", dispatch.astype(dt),
                               xf.astype(dt))

        w_in = self.param(
            "w_in", nn.initializers.lecun_normal(), (e, d, cfg.d_ff),
            jnp.float32,
        )
        b_in = self.param("b_in", nn.initializers.zeros, (e, cfg.d_ff),
                          jnp.float32)
        w_out = self.param(
            "w_out", nn.initializers.lecun_normal(), (e, cfg.d_ff, d),
            jnp.float32,
        )
        b_out = self.param("b_out", nn.initializers.zeros, (e, d),
                           jnp.float32)

        h = jnp.einsum("ecd,edf->ecf", expert_in, w_in.astype(dt))
        h = h + b_in[:, None, :].astype(dt)
        h = activation_fn(cfg.activation)(h)
        h = jnp.einsum("ecf,efd->ecd", h, w_out.astype(dt))
        h = h + b_out[:, None, :].astype(dt)

        out = jnp.einsum("nec,ecd->nd", combine.astype(dt), h)   # [N, D]

        # Switch load-balance loss: E * sum_e f_e * p_e  (f = routed fraction,
        # p = mean router prob) over REAL tokens; minimized at uniform
        # routing.
        denom = (
            jnp.maximum(jnp.sum(pad_mask), 1.0) if pad_mask is not None
            else jnp.float32(n)
        )
        frac = jnp.sum(onehot, axis=0) / denom
        prob = jnp.sum(probs, axis=0) / denom
        self.sow("aux_loss", "load_balance",
                 e * jnp.sum(frac * prob))

        return out.reshape(b, t, d)


class MoEBlock(nn.Module):
    """Pre-LN transformer block with a routed (MoE) FFN."""

    cfg: TransformerConfig
    n_experts: int = 4
    capacity_factor: float = 1.25

    @nn.compact
    def __call__(self, x: jnp.ndarray,
                 attn_mask: Optional[jnp.ndarray] = None,
                 pad_mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        cfg = self.cfg
        dt = cfg.compute_dtype
        h = nn.LayerNorm(dtype=jnp.float32, epsilon=cfg.ln_eps,
                         name="ln_attn")(x)
        h = nn.MultiHeadDotProductAttention(
            num_heads=cfg.n_heads, dtype=dt, qkv_features=cfg.d_model,
            out_features=cfg.d_model, name="attn",
        )(h, h, mask=attn_mask)
        x = x + h
        h = nn.LayerNorm(dtype=jnp.float32, epsilon=cfg.ln_eps,
                         name="ln_mlp")(x)
        return x + MoEMLP(cfg, self.n_experts, self.capacity_factor,
                          name="moe")(h, pad_mask)


class MoECausalLM(nn.Module):
    """CausalLM variant with MoE FFNs in every block (for ep pretraining)."""

    cfg: TransformerConfig
    n_experts: int = 4
    capacity_factor: float = 1.25

    @nn.compact
    def __call__(self, ids: jnp.ndarray, pad_mask: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        dt = cfg.compute_dtype
        tok = nn.Embed(cfg.vocab_size, cfg.d_model, dtype=dt, name="wte")
        pos = nn.Embed(cfg.max_len, cfg.d_model, dtype=dt, name="wpe")
        t = ids.shape[1]
        x = tok(ids) + pos(jnp.arange(t))[None, :, :]
        attn_mask = make_attention_mask(pad_mask.astype(bool), cfg.causal)
        for i in range(cfg.n_layers):
            x = MoEBlock(cfg, self.n_experts, self.capacity_factor,
                         name=f"block_{i}")(x, attn_mask, pad_mask)
        x = nn.LayerNorm(dtype=jnp.float32, epsilon=cfg.ln_eps,
                         name="ln_final")(x)
        logits = tok.attend(x.astype(dt)).astype(jnp.float32)
        return logits


def load_balance_loss(mutables: Any) -> jnp.ndarray:
    """Sum the sown per-layer Switch aux losses from ``mutable=['aux_loss']``."""
    leaves = jax.tree.leaves(mutables.get("aux_loss", {}))
    if not leaves:
        return jnp.float32(0.0)
    return sum(jnp.sum(l) for l in leaves) / len(leaves)


def shard_expert_params(params: Any, mesh: Any,
                        axis: str = "model") -> Any:
    """Shard every stacked expert leaf's leading ``[E, ...]`` axis over
    ``axis`` (expert parallelism); everything else is replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.shape[axis]

    def place(path: Any, leaf: Any) -> Any:
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        is_expert = any(str(k) in ("w_in", "w_out", "b_in", "b_out")
                        for k in names)
        if is_expert and leaf.ndim >= 1 and leaf.shape[0] % n == 0:
            spec = P(axis, *([None] * (leaf.ndim - 1)))
        else:
            spec = P(*([None] * leaf.ndim))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, params)


__all__ = [
    "MoEMLP",
    "MoEBlock",
    "MoECausalLM",
    "load_balance_loss",
    "shard_expert_params",
]
