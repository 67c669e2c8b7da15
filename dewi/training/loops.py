"""Jitted training loops: causal LM, ViT-MAE, CLIP (InfoNCE).

Each loop is one donated jitted ``train_step`` (params+opt state update in
place on device) driven by a host-side batch iterator.  Deliberately plain:
AdamW with cosine-decayed LR and gradient clipping — enough to pretrain the
byte-level backbones on a user corpus so the entropy signals become
semantically meaningful (at random init they are structurally correct but
content-blind).  For large runs, shard params with
:func:`dewi.parallel.tp.shard_params` and batches with
:func:`dewi.parallel.shard_batch` first — the steps are pure jit, so
GSPMD handles the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models.lm import token_nll
from ..models.registry import save_params


@dataclass
class TrainState:
    params: object
    opt_state: object
    step: int = 0
    losses: Optional[List[float]] = None


def _make_optimizer(lr: float, steps: int,
                    weight_decay: float = 0.01) -> Any:
    schedule = optax.cosine_decay_schedule(lr, decay_steps=max(steps, 1))
    return optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(schedule, weight_decay=weight_decay),
    )


def _run(loss_fn: Any, params: Any, batches: Any, optimizer: Any,
         log_every: int, progress: bool) -> Any:
    opt_state = optimizer.init(params)

    # Donating params/opt_state lets XLA update them in place — without it
    # both input and output copies stay live across the step (~2x the
    # params+Adam-moments HBM footprint).
    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params: Any, opt_state: Any, *batch: Any) -> Any:
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses: List[float] = []
    n = 0
    for batch in batches:
        params, opt_state, loss = step(params, opt_state, *batch)
        n += 1
        if n % log_every == 0 or n == 1:
            losses.append(float(loss))
            if progress:
                print(f"step {n}: loss {float(loss):.4f}", flush=True)
    return TrainState(params=params, opt_state=opt_state, step=n,
                      losses=losses)


# ---------------------------------------------------------------------------
# Causal LM
# ---------------------------------------------------------------------------


def lm_batches(
    texts: Sequence[str],
    tokenizer: Any,
    seq_len: int,
    batch_size: int,
    steps: int,
    seed: int = 0,
) -> Iterator[Tuple[jnp.ndarray, jnp.ndarray]]:
    """Random-sampled padded [B, T] id/mask batches from a text corpus."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        picks = rng.integers(0, len(texts), size=batch_size)
        ids, mask = tokenizer.encode_batch(
            [texts[i] for i in picks], seq_len, pad_to=seq_len
        )
        yield jnp.asarray(ids), jnp.asarray(mask)


def _lm_loop(loss_fn: Any, model: Any, params: Any,
             texts: Sequence[str], steps: int, batch_size: int, lr: float,
             tokenizer: Any, seq_len: Optional[int],
             checkpoint: Optional[str], log_every: int, progress: bool,
             seed: int) -> TrainState:
    """Shared LM-pretraining scaffold: tokenizer default, batch iterator,
    optimizer, run loop, checkpoint save.  ``loss_fn(params, ids, mask)``."""
    from ..signals.tokenizer import get_tokenizer

    tokenizer = tokenizer or get_tokenizer("byte")
    seq_len = int(seq_len or min(model.cfg.max_len, 128))
    state = _run(
        loss_fn, params,
        lm_batches(texts, tokenizer, seq_len, batch_size, steps, seed),
        _make_optimizer(lr, steps), log_every, progress,
    )
    if checkpoint:
        save_params(state.params, checkpoint)
    return state


def _masked_ce(logits: jnp.ndarray, ids: jnp.ndarray,
               mask: jnp.ndarray) -> jnp.ndarray:
    nll, valid = token_nll(logits, ids, mask)
    w = valid.astype(jnp.float32)
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)


def train_lm(
    model: Any,
    params: Any,
    texts: Sequence[str],
    steps: int = 200,
    batch_size: int = 32,
    lr: float = 3e-4,
    tokenizer: Any = None,
    seq_len: Optional[int] = None,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Next-token CE pretraining for :class:`dewi.models.CausalLM`."""

    def loss_fn(params: Any, ids: jnp.ndarray,
                mask: jnp.ndarray) -> jnp.ndarray:
        return _masked_ce(model.apply(params, ids, mask), ids, mask)

    return _lm_loop(loss_fn, model, params, texts, steps, batch_size, lr,
                    tokenizer, seq_len, checkpoint, log_every, progress, seed)


def train_moe_lm(
    model: Any,
    params: Any,
    texts: Sequence[str],
    steps: int = 200,
    batch_size: int = 32,
    lr: float = 3e-4,
    aux_weight: float = 0.01,
    tokenizer: Any = None,
    seq_len: Optional[int] = None,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Pretrain :class:`dewi.models.moe.MoECausalLM`: next-token CE plus
    the Switch load-balance aux loss (``aux_weight``, computed over real
    tokens only — the model drops padded positions from routing).  For
    expert parallelism, pass params through
    :func:`dewi.models.moe.shard_expert_params` first — the step is pure
    jit, so GSPMD keeps experts sharded through the update."""
    from ..models.moe import load_balance_loss

    def loss_fn(params: Any, ids: jnp.ndarray,
                mask: jnp.ndarray) -> jnp.ndarray:
        logits, mut = model.apply(params, ids, mask, mutable=["aux_loss"])
        return _masked_ce(logits, ids, mask) + \
            aux_weight * load_balance_loss(mut)

    return _lm_loop(loss_fn, model, params, texts, steps, batch_size, lr,
                    tokenizer, seq_len, checkpoint, log_every, progress, seed)


# ---------------------------------------------------------------------------
# MAE
# ---------------------------------------------------------------------------


def train_mae(
    model: Any,
    params: Any,
    images: np.ndarray,
    steps: int = 200,
    batch_size: int = 16,
    lr: float = 1e-3,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Masked-reconstruction pretraining for :class:`dewi.models.ViTMAE`.

    ``images``: ``[N, H, W, 3]`` f32 in [0, 1], already at the model's
    ``image_size``.
    """
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)

    def batches() -> Any:
        for s in range(steps):
            picks = rng.integers(0, len(images), size=batch_size)
            yield (jnp.asarray(images[picks]),
                   jax.random.fold_in(key, s))

    def loss_fn(params: Any, imgs: jnp.ndarray,
                rng_key: jnp.ndarray) -> jnp.ndarray:
        return jnp.mean(model.apply(params, imgs, rng_key))

    state = _run(loss_fn, params, batches(), _make_optimizer(lr, steps),
                 log_every, progress)
    if checkpoint:
        save_params(state.params, checkpoint)
    return state


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def train_clip(
    model: Any,
    params: Any,
    texts: Sequence[str],
    images: np.ndarray,
    steps: int = 200,
    batch_size: int = 32,
    lr: float = 1e-3,
    tokenizer: Any = None,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Symmetric-InfoNCE contrastive training for the CLIP dual encoder.

    ``texts[i]`` captions ``images[i]``; in-batch negatives, both softmax
    directions averaged (the standard CLIP objective).
    """
    from ..signals.tokenizer import get_tokenizer

    if len(texts) != len(images):
        raise ValueError("texts and images must align")
    tokenizer = tokenizer or get_tokenizer("byte")
    text_len = model.cfg.text_len
    rng = np.random.default_rng(seed)

    def batches() -> Any:
        for _ in range(steps):
            picks = rng.integers(0, len(texts), size=batch_size)
            ids, mask = tokenizer.encode_batch(
                [texts[i] for i in picks], text_len, pad_to=text_len
            )
            yield (jnp.asarray(ids), jnp.asarray(mask),
                   jnp.asarray(images[picks]))

    def loss_fn(params: Any, ids: jnp.ndarray, mask: jnp.ndarray,
                imgs: jnp.ndarray) -> jnp.ndarray:
        t, v, logit_scale = model.apply(params, ids, mask, imgs)
        scale = jnp.exp(jnp.clip(logit_scale, -5.0, jnp.log(100.0)))
        logits = scale * jnp.dot(t, v.T)                    # [B, B]
        labels = jnp.arange(logits.shape[0])
        loss_t = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels
        ).mean()
        loss_v = optax.softmax_cross_entropy_with_integer_labels(
            logits.T, labels
        ).mean()
        return 0.5 * (loss_t + loss_v)

    state = _run(loss_fn, params, batches(), _make_optimizer(lr, steps),
                 log_every, progress)
    if checkpoint:
        save_params(state.params, checkpoint)
    return state


__all__ = ["TrainState", "train_lm", "train_mae", "train_clip",
           "train_moe_lm", "lm_batches"]
