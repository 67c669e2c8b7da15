"""Causal language model for token-surprisal estimation.

Replacement for the reference's torch GPT-2 NLL path (reference
text_entropy.py:60-92): the forward, logit shift, and per-token
cross-entropy run as one jitted XLA program over padded ``[B, T]`` batches.
Per-token NLL is computed with a gather-based log-softmax (no materialized
one-hot) so the hot op is the ``[B, T, V]`` logits matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from .transformer import Encoder, Module, TransformerConfig, init_embed


@dataclasses.dataclass(frozen=True)
class CausalLM(Module):
    """GPT-2-style decoder: tied-embedding LM head over byte/BPE tokens."""

    cfg: TransformerConfig

    def init_params(self, rng: jax.Array, *args: Any) -> dict:
        cfg = self.cfg
        kt, kp, ke = jax.random.split(rng, 3)
        return {
            "wte": init_embed(kt, cfg.vocab_size, cfg.d_model),
            "wpe": init_embed(kp, cfg.max_len, cfg.d_model),
            "encoder": Encoder(cfg).init_params(ke),
        }

    def __call__(self, params: dict, ids: jnp.ndarray,
                 pad_mask: jnp.ndarray) -> jnp.ndarray:
        """Return logits ``[B, T, V]`` (float32) for next-token prediction."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        wte = params["wte"]["embedding"].astype(dt)
        t = ids.shape[1]
        x = wte[ids] + params["wpe"]["embedding"][:t].astype(dt)[None]
        x = Encoder(cfg)(params["encoder"], x, pad_mask)
        # Tied LM head: logits = x @ wte^T, accumulated in f32.
        return jnp.dot(x.astype(dt), wte.T).astype(jnp.float32)


def token_nll(
    logits: jnp.ndarray, ids: jnp.ndarray, pad_mask: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-token next-token NLL from shifted logits.

    Parity with the reference's shift + ``CrossEntropyLoss(reduction='none')``
    (reference text_entropy.py:63-73): position ``i`` of the output is the
    NLL of token ``i+1`` given tokens ``<= i``.  Returns ``(nll [B, T-1],
    valid_mask [B, T-1])`` where positions whose *target* is padding are
    masked out.
    """
    shift_logits = logits[:, :-1, :]
    targets = ids[:, 1:]
    logz = jax.nn.logsumexp(shift_logits, axis=-1)
    tgt_logit = jnp.take_along_axis(
        shift_logits, targets[..., None], axis=-1
    ).squeeze(-1)
    nll = logz - tgt_logit
    valid = pad_mask[:, 1:].astype(bool)
    return nll, valid


__all__ = ["CausalLM", "token_nll"]
