"""Ring attention: exact attention over a sequence axis too long for one chip.

No reference counterpart (SURVEY.md §2.3 lists ring attention among the
parallelism the reference lacks entirely); this is the long-context scaling
primitive for the LM surprisal signal — `signals/text_entropy.py` scores
long documents with overlapping windows on one chip, and ring attention is
the multi-chip alternative that keeps the WHOLE context exact.

Design:

* Q/K/V shard their sequence axis over a mesh axis; each device holds a
  ``[B, H, T/S, Dh]`` block.
* Attention runs blockwise with the **online softmax** (flash-style running
  max / normalizer / accumulator), so nothing of size ``[T, T]`` ever
  materializes — per step the score block is ``[T/S, T/S]``.
* After each step every device hands its K/V block to the next device with
  one ``lax.ppermute`` — S-1 single interconnect hops move every block past every
  query shard, and compute overlaps the neighbor exchange (the scan body
  issues the permute alongside the matmuls; XLA overlaps collective and
  matmul work).
* Causal and key-padding masks are applied with *global* positions
  reconstructed from the device's ring offset, so results are bit-equal in
  structure to single-device attention.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import MODEL_AXIS

NEG_INF = -3.4e38


def _online_block(carry: Any, sc: jax.Array, vb: jax.Array) -> Any:
    """One online-softmax update.  sc [..., Tq, Tk], vb [..., Tk, Dh]."""
    m, l, acc = carry
    m_blk = jnp.max(sc, axis=-1)                         # [..., Tq]
    m_new = jnp.maximum(m, m_blk)
    # Rows that have seen no unmasked key yet: keep exp() well-defined.
    safe = jnp.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = jnp.exp(sc - safe[..., None])                    # [..., Tq, Tk]
    corr = jnp.exp(m - safe)                             # [..., Tq]
    l_new = l * corr + jnp.sum(p, axis=-1)
    acc_new = acc * corr[..., None] + jnp.einsum(
        "...qk,...kd->...qd", p.astype(vb.dtype), vb
    ).astype(jnp.float32)
    return m_new, l_new, acc_new


def ring_attention(
    q: jax.Array,                 # [B, H, T, Dh] sequence-sharded over axis
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis: str = MODEL_AXIS,
    causal: bool = True,
    pad_mask: Optional[jax.Array] = None,   # [B, T] 1=real, 0=pad
) -> jax.Array:
    """Exact attention with the sequence axis sharded over ``axis``.

    Returns ``[B, H, T, Dh]`` float32, sharded like ``q``.  Equals
    single-device softmax attention (tests/test_ring.py parity).
    """
    n_dev = mesh.shape[axis]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if pad_mask is None:
        pad_mask = jnp.ones(q.shape[0], jnp.float32)[:, None] * jnp.ones(
            (1, q.shape[2]), jnp.float32
        )

    spec = P(None, None, axis, None)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec, P(None, axis)),
        out_specs=spec,
        check_vma=False,
    )
    def run(ql: jax.Array, kl: jax.Array, vl: jax.Array,
            padl: jax.Array) -> jax.Array:
        sid = jax.lax.axis_index(axis)
        tl = ql.shape[2]
        qpos = sid * tl + jnp.arange(tl)                 # global q positions
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        m0 = jnp.full(ql.shape[:3], NEG_INF, jnp.float32)
        l0 = jnp.zeros(ql.shape[:3], jnp.float32)
        acc0 = jnp.zeros(ql.shape, jnp.float32)

        def step(carry: Any, i: Any) -> Any:
            kb, vb, padb, m, l, acc = carry
            # kb currently holds global block (sid - i) mod n_dev.
            blk = (sid - i) % n_dev
            kpos = blk * tl + jnp.arange(tl)
            sc = jnp.einsum(
                "bhqd,bhkd->bhqk", ql, kb,
                preferred_element_type=jnp.float32,
            ) * scale
            mask = padb[:, None, None, :] > 0            # [B, 1, 1, Tk]
            if causal:
                mask = jnp.logical_and(
                    mask, (kpos[None, :] <= qpos[:, None])[None, None]
                )
            sc = jnp.where(mask, sc, NEG_INF)
            m, l, acc = _online_block((m, l, acc), sc, vb)
            kb, vb, padb = jax.lax.ppermute((kb, vb, padb), axis, perm)
            return (kb, vb, padb, m, l, acc), None

        (kb, vb, padb, m, l, acc), _ = jax.lax.scan(
            step, (kl, vl, padl, m0, l0, acc0), jnp.arange(n_dev)
        )
        return acc / jnp.maximum(l, 1e-30)[..., None]

    return run(q, k, v, pad_mask.astype(jnp.float32))


def _layernorm(x: jax.Array, p: Any, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    return (xf - mu) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def ring_lm_logits(
    cfg: Any,
    params: Any,
    ids: jax.Array,              # [B, T] int32, T % mesh[axis] == 0
    pad_mask: jax.Array,         # [B, T]
    mesh: Mesh,
    axis: str = MODEL_AXIS,
) -> jax.Array:
    """CausalLM forward with ring attention: exact logits for contexts that
    exceed one chip's memory.

    Everything except attention (embeddings, LayerNorms, MLPs, LM head) is
    token-pointwise, so GSPMD shards it over the sequence axis for free; the
    attention itself is the :func:`ring_attention` shard_map.  Output logits
    are numerically the single-device ``CausalLM.apply`` result
    (tests/test_ring.py parity) — this is the multi-chip path for
    long-document surprisal (signals/text_entropy.py scores windows on one
    chip; this scores the WHOLE document exactly).
    """
    from .mesh import DATA_AXIS

    # Batch dim shards over 'data' only when it divides evenly (a [1, T]
    # long-doc batch on a data>1 mesh must replicate, not crash).
    n_data = mesh.shape.get(DATA_AXIS, 1)
    b_axis = DATA_AXIS if int(ids.shape[0]) % max(n_data, 1) == 0 and \
        n_data > 1 else None
    sharding = NamedSharding(mesh, P(b_axis, axis))
    ids = jax.device_put(jnp.asarray(np.asarray(ids)), sharding)
    pad_mask = jax.device_put(
        jnp.asarray(np.asarray(pad_mask), jnp.float32), sharding
    )

    fwd = _cached_lm_fwd(cfg, mesh, axis)
    with jax.set_mesh(mesh):
        return fwd(params["params"], ids, pad_mask)


@functools.lru_cache(maxsize=32)
def _cached_lm_fwd(cfg: Any, mesh: Mesh, axis: str) -> Any:
    """Jitted ring-LM forward, cached per (cfg, mesh, axis) — a fresh jit
    per call would retrace the whole model for every document."""
    from ..models.transformer import activation_fn

    dt = cfg.compute_dtype
    act = activation_fn(cfg.activation)

    @jax.jit
    def fwd(pp: Any, ids: jax.Array, pad_mask: jax.Array) -> jax.Array:
        t = ids.shape[1]
        wte = pp["wte"]["embedding"]
        wpe = pp["wpe"]["embedding"]
        x = wte[ids].astype(dt) + wpe[jnp.arange(t)][None].astype(dt)
        n_layers = sum(1 for k in pp["encoder"] if k.startswith("block_"))
        for i in range(n_layers):
            blk = pp["encoder"][f"block_{i}"]
            h = _layernorm(x, blk["ln_attn"], cfg.ln_eps).astype(dt)
            a = blk["attn"]
            q = jnp.einsum("btd,dhf->bhtf", h, a["query"]["kernel"].astype(dt))
            q = q + a["query"]["bias"].astype(dt)[None, :, None, :]
            k = jnp.einsum("btd,dhf->bhtf", h, a["key"]["kernel"].astype(dt))
            k = k + a["key"]["bias"].astype(dt)[None, :, None, :]
            v = jnp.einsum("btd,dhf->bhtf", h, a["value"]["kernel"].astype(dt))
            v = v + a["value"]["bias"].astype(dt)[None, :, None, :]
            o = ring_attention(q, k, v, mesh, axis=axis,
                               causal=cfg.causal, pad_mask=pad_mask)
            o = jnp.einsum("bhtf,hfd->btd", o.astype(dt),
                           a["out"]["kernel"].astype(dt))
            o = o + a["out"]["bias"].astype(dt)
            x = x + o
            h = _layernorm(x, blk["ln_mlp"], cfg.ln_eps).astype(dt)
            m = blk["mlp"]
            h = act(h @ m["fc_in"]["kernel"].astype(dt)
                    + m["fc_in"]["bias"].astype(dt))
            h = h @ m["fc_out"]["kernel"].astype(dt) + m["fc_out"]["bias"].astype(dt)
            x = x + h
        x = _layernorm(x, pp["encoder"]["ln_final"], cfg.ln_eps)
        return jnp.dot(x.astype(dt), wte.T.astype(dt),
                       preferred_element_type=jnp.float32)

    return fwd


__all__ = ["ring_attention", "ring_lm_logits"]
