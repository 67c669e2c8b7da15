"""Fused stage-1 + sub-block max kernel for the quantized search tiers.

Stage 1 of :func:`dewi.ops.quantized.quantized_search` scores every
corpus row against the queries, folds the dequant scale and the DEWI
re-rank into one multiply-add, and keeps only the max of each 128-row
sub-block (blockmax selection: stage 2 re-ranks the winning sub-blocks
exactly in f32).  XLA runs that as two passes — a GEMM that writes the
``[Q, cap]`` f32 scores, then a max-reduce that reads them back.  This
kernel does it in one: each program scores a tile of corpus rows for a
tile of queries and writes only the ``[Q, rows/128]`` maxima, so nothing
of size ``[Q, cap]`` reaches device memory.  It is also the only stage-1
path that reads the int4 tier's nibble-packed bytes instead of an
unpacked int8-width copy.

Written for the GPU through Pallas' Triton route: programs carry no state
between them (blocks run in parallel, in no order), the grid is
``(corpus tiles, query tiles)``, and queries are padded to at least 16 rows
because the Triton dot needs every operand dimension >= 16.  Three operand
modes share one kernel body:

* ``bf16``: f32 queries cast to bf16, int8 corpus converted to bf16 in
  registers, f32 accumulation;
* ``s8``: int8 queries x int8 corpus, int32 accumulation, the query scale
  folded into the epilogue;
* ``s4``: int8 queries x nibble-packed int4 corpus (the layout of
  :func:`dewi.ops.quantized.quantize_rows_int4`): each packed byte is
  split in registers into its high nibble (dimension ``j``) and its
  biased low nibble (dimension ``j + D/2``), and the two halves of the
  query contract against them in two int32 dots.

``interpret=True`` runs the same kernel through the Pallas interpreter on
any backend; the tests use it on the CPU.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

SUB = 128          # corpus rows per sub-block max (== ops.quantized.BLOCKMAX_SUB)
MIN_Q_TILE = 16    # the Triton dot needs every operand dimension >= 16
MAX_Q_TILE = 64    # larger query batches add query tiles to the grid
SUBS_PER_PROGRAM = 8   # sub-blocks one program walks (1024 corpus rows)
NUM_WARPS = 4
NUM_STAGES = 3
MODES = ("bf16", "s8", "s4")


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def kernel_runs_here() -> bool:
    """The kernel path is taken on the GPU; every other backend takes XLA's
    two-pass path (tests reach the kernel there with ``interpret=True``)."""
    return jax.default_backend() == "gpu"


def kernel_fits(cap: int, dim: int, mode: str) -> bool:
    """True when the corpus shape maps onto the kernel's power-of-two tiles.

    Triton tiles are powers of two: the (packed) row width must be one and
    at least 16 wide, and the capacity a whole number of 128-row
    sub-blocks.  A shape that does not fit takes the XLA two-pass path."""
    width = dim // 2 if mode == "s4" else dim
    return (
        mode in MODES and cap % SUB == 0 and _pow2(width) and width >= 16
        and (mode != "s4" or dim % 2 == 0)
    )


def _bmax_kernel(*refs: Any, mode: str, n_sub: int) -> None:
    # refs: P query refs [BQ, W] (bf16 / int8; the two query halves for
    # "s4", else one), e_ref [n_sub*SUB, W] int8, qs_ref [BQ] f32,
    # mult_ref / add_ref [n_sub*SUB] f32, o_ref [BQ, n_sub] f32.
    *q_refs, e_ref, qs_ref, mult_ref, add_ref, o_ref = refs
    dims = (((1,), (1,)), ((), ()))
    qs = qs_ref[...]
    q_parts = [r[...] for r in q_refs]
    col = jax.lax.broadcasted_iota(jnp.int32, o_ref.shape, 1)

    def body(j: Any, out: Any) -> Any:
        rows = pl.ds(pl.multiple_of(j * SUB, SUB), SUB)
        e = e_ref[rows, :]
        if mode == "bf16":
            acc = jax.lax.dot_general(q_parts[0], e.astype(jnp.bfloat16), dims,
                                      preferred_element_type=jnp.float32)
        else:
            # s4: high nibble = dimension j (arithmetic shift keeps the
            # sign), biased low nibble = dimension j + D/2.
            e_parts = (e,) if mode == "s8" else (e >> 4, (e & 15) - 8)
            acc = sum(
                jax.lax.dot_general(qp, ep, dims,
                                    preferred_element_type=jnp.int32)
                for qp, ep in zip(q_parts, e_parts)
            ).astype(jnp.float32) * qs[:, None]
        adj = acc * mult_ref[rows][None, :] + add_ref[rows][None, :]
        # The sub-block maxima gather in registers; the tile is stored once.
        return jnp.where(col == j, jnp.max(adj, axis=1)[:, None], out)

    o_ref[...] = jax.lax.fori_loop(
        0, n_sub, body, jnp.zeros(o_ref.shape, jnp.float32))


@functools.partial(jax.jit, static_argnames=("mode", "interpret"))
def pallas_bmax(
    emb: jax.Array,      # [cap, D] int8 ([cap, D/2] packed int4 for "s4")
    mult: jax.Array,     # [cap] f32 per-row multiplier (dequant scale fold)
    add: jax.Array,      # [cap] f32 per-row addend (re-rank + mask fold)
    q: jax.Array,        # [Q, D] f32 queries ("bf16") or int8 ("s8"/"s4")
    q_scale: jax.Array,  # [Q] f32 per-query dequant scales (ones for "bf16")
    mode: str = "bf16",
    interpret: bool = False,
) -> jax.Array:
    """Fused stage-1 scores + 128-row sub-block max: ``[Q, cap/128]`` f32.

    Equals ``max over each sub-block of (q . e) * q_scale * mult + add``,
    the value the XLA two-pass path computes."""
    cap, width = emb.shape
    nq, d = q.shape
    assert mode in MODES, mode
    assert width == (d // 2 if mode == "s4" else d), (emb.shape, q.shape)
    assert kernel_fits(cap, d, mode), (cap, d, mode)
    nb = cap // SUB
    n_sub = SUBS_PER_PROGRAM
    while nb % n_sub:
        n_sub //= 2
    bq = MIN_Q_TILE
    while bq < nq and bq < MAX_Q_TILE:
        bq *= 2
    qp = -(-nq // bq) * bq
    q = q.astype(jnp.bfloat16 if mode == "bf16" else jnp.int8)
    q_scale = q_scale.astype(jnp.float32)
    if qp != nq:
        q = jnp.pad(q, ((0, qp - nq), (0, 0)))
        q_scale = jnp.pad(q_scale, (0, qp - nq))
    # The s4 kernel contracts each query half against one nibble plane; the
    # halves come in as separate operands (a kernel cannot slice a loaded
    # tile).
    q_parts = [q[:, p * width:(p + 1) * width] for p in range(d // width)]
    out = pl.pallas_call(
        functools.partial(_bmax_kernel, mode=mode, n_sub=n_sub),
        grid=(nb // n_sub, qp // bq),
        in_specs=[
            *[pl.BlockSpec((bq, width), lambda i, j: (j, 0))
              for _ in q_parts],
            pl.BlockSpec((n_sub * SUB, width), lambda i, j: (i, 0)),
            pl.BlockSpec((bq,), lambda i, j: (j,)),
            pl.BlockSpec((n_sub * SUB,), lambda i, j: (i,)),
            pl.BlockSpec((n_sub * SUB,), lambda i, j: (i,)),
        ],
        # Query-major [Qp, cap/128]: the result is consumed as is.  A
        # corpus-major output read through a transpose reaches XLA's GPU
        # TopK as a column-major bitcast, which that kernel misreads.
        out_specs=pl.BlockSpec((bq, n_sub), lambda i, j: (j, i)),
        out_shape=jax.ShapeDtypeStruct((qp, nb), jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        backend="triton",
        name="dewi_bmax_" + mode,
    )(*q_parts, emb, q_scale, mult.astype(jnp.float32),
      add.astype(jnp.float32))
    return out[:nq]


__all__ = [
    "pallas_bmax", "kernel_fits", "kernel_runs_here", "MODES", "SUB",
]
