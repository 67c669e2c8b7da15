"""Pipeline parallelism: GPipe-style microbatch schedule over a ``stage`` axis.

No reference counterpart — the reference is single-process, single-GPU torch
(SURVEY.md §2.3: zero parallelism of any kind); this layer exists so the
in-repo backbone pretraining (``training/loops.py``) scales past one chip
when the model axis is the constraint.

Design (vs the reference's would-be NCCL send/recv):

* Layers are **stacked**: the per-layer param trees of the ``Encoder`` become
  one pytree whose leaves carry a leading ``[L, ...]`` layer axis, sharded
  over the mesh's ``stage`` axis — each device materializes only its own
  ``L/S`` layers.
* The schedule is a ``lax.scan`` over ``M + S - 1`` ticks inside one
  ``shard_map``: at tick ``t`` stage ``s`` runs microbatch ``t - s`` through
  its local layers (a ``lax.scan`` over the stacked leaf axis) and hands the
  activation to stage ``s+1`` with a single ``lax.ppermute`` — the
  activation transfer is one interconnect hop per tick, exactly the neighbor-exchange
  the torus is built for.
* The **backward pipeline comes from autodiff**: ``jax.grad`` through the
  scan + ppermute emits the reversed schedule (inverse permutation, reverse
  tick order) — no hand-written bwd schedule, no 1F1B bookkeeping.
* Composes with data parallelism by sharding the microbatch batch axis over
  ``data`` in the same ``shard_map``; embedding/head/loss stay outside in
  plain GSPMD land.

Bubble fraction is the GPipe ``(S-1)/(M+S-1)``; pick ``n_microbatches >= 4*S``
for <20% bubble.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.transformer import Block, TransformerConfig, make_attention_mask


# -- param restructuring -------------------------------------------------------


def stack_block_params(params: Any, n_layers: int) -> tuple[Any, Any]:
    """Split CausalLM params into (stacked block tree, the rest).

    The stacked tree mirrors one ``Block``'s params with every leaf gaining a
    leading ``[L, ...]`` axis (the scan-over-layers form); ``rest`` is the
    original tree with ``encoder/block_i`` removed (embeddings, final LN).
    """
    enc = params["params"]["encoder"]
    blocks = [enc[f"block_{i}"] for i in range(n_layers)]
    stacked = jax.tree.map(lambda *ls: jnp.stack(ls, axis=0), *blocks)
    rest = {
        "params": {
            **{k: v for k, v in params["params"].items() if k != "encoder"},
            "encoder": {k: v for k, v in enc.items()
                        if not k.startswith("block_")},
        }
    }
    return stacked, rest


def unstack_block_params(stacked: Any, rest: Any, n_layers: int) -> Any:
    """Inverse of :func:`stack_block_params` (for checkpoint round-trips)."""
    enc = dict(rest["params"]["encoder"])
    for i in range(n_layers):
        enc[f"block_{i}"] = jax.tree.map(lambda a, _i=i: a[_i], stacked)
    return {"params": {**{k: v for k, v in rest["params"].items()
                          if k != "encoder"}, "encoder": enc}}


def shard_stacked_params(stacked: Any, mesh: Mesh,
                         stage_axis: str = "stage") -> Any:
    """Place stacked block params with the layer axis sharded over stages."""
    def place(leaf: Any) -> Any:
        spec = P(stage_axis, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))
    return jax.tree.map(place, stacked)


# -- embedding / head (manual, parity with CausalLM.apply) ---------------------


def _embed(rest: Any, ids: jnp.ndarray, cfg: TransformerConfig) -> jnp.ndarray:
    dt = cfg.compute_dtype
    wte = rest["params"]["wte"]["embedding"]
    wpe = rest["params"]["wpe"]["embedding"]
    t = ids.shape[-1]
    return wte[ids].astype(dt) + wpe[jnp.arange(t)][None, :, :].astype(dt)


def _head(rest: Any, x: jnp.ndarray, cfg: TransformerConfig) -> jnp.ndarray:
    ln = rest["params"]["encoder"]["ln_final"]
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    h = (xf - mu) * jax.lax.rsqrt(var + cfg.ln_eps)
    h = h * ln["scale"] + ln["bias"]
    wte = rest["params"]["wte"]["embedding"]
    dt = cfg.compute_dtype
    return jnp.dot(h.astype(dt), wte.T.astype(dt),
                   preferred_element_type=jnp.float32)


# -- the pipeline --------------------------------------------------------------


def pipeline_blocks(
    cfg: TransformerConfig,
    stacked: Any,
    x_mb: jnp.ndarray,          # [M, Bmb, T, D] embedded microbatches
    attn_mb: jnp.ndarray,       # [M, Bmb, 1, T, T] attention masks
    mesh: Mesh,
    stage_axis: str = "stage",
    data_axis: Optional[str] = "data",
    remat: bool = True,
) -> jnp.ndarray:
    """Run the stacked Block stack as a GPipe pipeline; returns [M, Bmb, T, D].

    ``stacked`` leaves are ``[L, ...]`` with ``L % n_stages == 0``; inside the
    shard_map each stage sees its local ``[L/S, ...]`` shard and scans over
    it.  Batch dims shard over ``data_axis`` when present in the mesh.
    """
    n_stages = mesh.shape[stage_axis]
    dp = (P(None, data_axis, None, None)
          if data_axis and data_axis in mesh.shape else
          P(None, None, None, None))
    mask_spec = P(dp[0], dp[1], None, None, None)

    def block_fn(x: jax.Array, p: Any, m: jax.Array) -> jax.Array:
        return Block(cfg).apply({"params": p}, x, m)

    if remat:
        block_fn = jax.checkpoint(block_fn)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            jax.tree.map(
                lambda leaf: P(stage_axis, *([None] * (leaf.ndim - 1))),
                stacked,
            ),
            dp,
            mask_spec,
        ),
        out_specs=dp,
        check_vma=False,
    )
    def run(stacked_local: Any, mbs: jax.Array, masks: jax.Array) -> Any:
        sid = jax.lax.axis_index(stage_axis)
        n_mb = mbs.shape[0]
        ticks = n_mb + n_stages - 1

        def apply_local(x: jax.Array, mask: jax.Array) -> jax.Array:
            def body(h: jax.Array, p: Any) -> Any:
                return block_fn(h, p, mask), None
            x, _ = jax.lax.scan(body, x, stacked_local)
            return x

        def tick(carry: Any, t: Any) -> Any:
            state, outbuf = carry
            # Stage s works on microbatch t - s this tick.
            my_mb = jnp.clip(t - sid, 0, n_mb - 1)
            mb_in = jax.lax.dynamic_index_in_dim(mbs, my_mb, keepdims=False)
            mask = jax.lax.dynamic_index_in_dim(masks, my_mb, keepdims=False)
            x = jnp.where(sid == 0, mb_in, state)
            y = apply_local(x, mask)
            # Last stage has finished microbatch t-(S-1); bank it.
            out_t = t - (n_stages - 1)
            write = jnp.logical_and(sid == n_stages - 1, out_t >= 0)
            slot = jnp.clip(out_t, 0, n_mb - 1)
            cur = jax.lax.dynamic_index_in_dim(outbuf, slot, keepdims=False)
            outbuf = jax.lax.dynamic_update_index_in_dim(
                outbuf, jnp.where(write, y, cur), slot, axis=0
            )
            # One interconnect hop: every stage hands its activation to the next.
            state = jax.lax.ppermute(
                y, stage_axis,
                [(i, (i + 1) % n_stages) for i in range(n_stages)],
            )
            return (state, outbuf), None

        state0 = jnp.zeros_like(mbs[0])
        out0 = jnp.zeros_like(mbs)
        (_, outbuf), _ = jax.lax.scan(
            tick, (state0, out0), jnp.arange(ticks)
        )
        # Only the last stage holds real outputs; replicate across stages
        # (everyone else contributes zeros).
        outbuf = jnp.where(sid == n_stages - 1, outbuf,
                           jnp.zeros_like(outbuf))
        return jax.lax.psum(outbuf, stage_axis)

    return run(stacked, x_mb, attn_mb)


def pipelined_lm_logits(
    cfg: TransformerConfig,
    stacked: Any,
    rest: Any,
    ids: jnp.ndarray,           # [B, T]
    pad_mask: jnp.ndarray,      # [B, T]
    mesh: Mesh,
    n_microbatches: int,
    stage_axis: str = "stage",
    data_axis: Optional[str] = "data",
    remat: bool = True,
) -> jnp.ndarray:
    """Full CausalLM forward with the block stack pipelined; logits [B,T,V]."""
    b, t = ids.shape
    assert b % n_microbatches == 0, (
        f"batch {b} must divide into {n_microbatches} microbatches"
    )
    x = _embed(rest, ids, cfg)
    attn = make_attention_mask(pad_mask.astype(bool), cfg.causal)
    bmb = b // n_microbatches
    x_mb = x.reshape(n_microbatches, bmb, t, -1)
    attn_mb = attn.reshape(n_microbatches, bmb, *attn.shape[1:])
    y = pipeline_blocks(cfg, stacked, x_mb, attn_mb, mesh,
                        stage_axis=stage_axis, data_axis=data_axis,
                        remat=remat)
    y = y.reshape(b, t, -1)
    return _head(rest, y, cfg)


def pp_train_step(
    cfg: TransformerConfig,
    optimizer: Any,
    mesh: Mesh,
    n_microbatches: int,
    stage_axis: str = "stage",
    data_axis: Optional[str] = "data",
) -> Any:
    """Build a jitted pipeline-parallel LM training step.

    Returns ``step((stacked, rest), opt_state, ids, pad_mask) ->
    ((stacked, rest), opt_state, loss)``.  Gradients flow through the
    pipeline via autodiff (reverse ppermute schedule); the optimizer update
    keeps the stage sharding (params and grads share layout, so GSPMD keeps
    Adam moments sharded by stage too).
    """
    from ..models.lm import token_nll

    def loss_fn(params: Any, ids: jax.Array, pad_mask: jax.Array) -> Any:
        stacked, rest = params
        logits = pipelined_lm_logits(
            cfg, stacked, rest, ids, pad_mask, mesh, n_microbatches,
            stage_axis=stage_axis, data_axis=data_axis,
        )
        nll, valid = token_nll(logits, ids, pad_mask)
        v = valid.astype(jnp.float32)
        return jnp.sum(nll * v) / jnp.maximum(jnp.sum(v), 1.0)

    import optax

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params: Any, opt_state: Any, ids: jax.Array,
             pad_mask: jax.Array) -> Any:
        loss, grads = jax.value_and_grad(loss_fn)(params, ids, pad_mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return step


__all__ = [
    "stack_block_params",
    "unstack_block_params",
    "shard_stacked_params",
    "pipeline_blocks",
    "pipelined_lm_logits",
    "pp_train_step",
]
