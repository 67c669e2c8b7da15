"""Sequence (context) parallelism for the LM surprisal path.

The reference runs each document through one single-device forward with no
sequence scaling at all (reference text_entropy.py:55-73; SURVEY.md §5
"long-context: absent").  Here the sequence axis is made shardable the
GSPMD way: annotate the token batch with a ``P(data, model)`` sharding and
jit the ordinary Flax forward inside the mesh — XLA's SPMD partitioner
derives the attention collectives (the QK^T and AV dot-generals contract
over the sharded axis, inducing all-gathers over the interconnect).  No ring-attention
kernel is needed at DEWI backbone sizes; this keeps the door open for one
later without changing the API.

Composes with tensor parallelism: params sharded by ``tp.shard_params``
while activations shard by ``(batch, sequence)``.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, MODEL_AXIS


def shard_tokens(
    ids: np.ndarray,
    mask: np.ndarray,
    mesh: Mesh,
    seq_axis: Optional[str] = MODEL_AXIS,
) -> Any:
    """Place ``[B, T]`` token batches as (batch=data, sequence=seq_axis).

    ``T`` must divide by the sequence-axis size (bucketed lengths are powers
    of two, so any power-of-two mesh axis divides them).  Pass
    ``seq_axis=None`` to shard only the batch axis.
    """
    spec = P(DATA_AXIS, seq_axis)
    sharding = NamedSharding(mesh, spec)
    return (
        jax.device_put(np.asarray(ids), sharding),
        jax.device_put(np.asarray(mask), sharding),
    )


def sequence_sharded_nll(model: Any, params: Any, ids: np.ndarray,
                         mask: np.ndarray, mesh: Mesh,
                         seq_axis: str = MODEL_AXIS) -> Any:
    """Per-token NLL with the sequence axis sharded over ``seq_axis``.

    Returns ``(nll [B, T-1], valid [B, T-1])`` — identical values to the
    replicated forward (GSPMD inserts the attention collectives).
    """
    from ..models.lm import token_nll

    ids_s, mask_s = shard_tokens(ids, mask, mesh, seq_axis)
    with jax.set_mesh(mesh):
        logits = jax.jit(model.apply)(params, ids_s, mask_s)
        return token_nll(logits, ids_s, mask_s)


__all__ = ["shard_tokens", "sequence_sharded_nll"]
