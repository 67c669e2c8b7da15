"""Data-parallel placement for signal-estimator device batches.

The estimator forwards — LM surprisal, MAE reconstruction, the CLIP
towers — are the dominant cost of corpus processing; the reference runs
them as single-GPU torch loops (reference pipelines.py:87-160,
text_entropy.py:101-121).  This module makes the SAME jitted forwards run
over every device of a ``jax.sharding.Mesh``:

* model parameters are replicated over the mesh once (:meth:`DataParallel.
  replicate`);
* every input batch is placed sharded over the ``data`` axis
  (:meth:`DataParallel.put`), so XLA's SPMD partitioner compiles the
  estimator's existing ``jax.jit`` programs across all devices — the
  per-document signal math is row-independent, so no collectives are
  inserted on the forward path;
* batch sizes are rounded up to a multiple of the data-axis size
  (:meth:`DataParallel.round_batch`) so every dispatch divides evenly
  (estimators already pad every batch to a static ``batch_size``).

Held by each estimator when :class:`dewi.pipelines.DewiPipeline` is
constructed with a ``mesh`` (or ``config.mesh.data_parallel_signals`` is
set) — this is what makes corpus signal extraction scale with the mesh
instead of running on one chip while search/scoring shard.
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS


class DataParallel:
    """Sharding adapter handed to estimators for mesh execution.

    Single-device meshes degrade to plain placement (the spec is
    effectively replicated), so the same code path serves one card and a
    multi-card host.
    """

    def __init__(self, mesh: Mesh) -> None:
        if DATA_AXIS not in mesh.shape:
            raise ValueError(
                f"mesh {dict(mesh.shape)} has no {DATA_AXIS!r} axis"
            )
        self.mesh = mesh
        self.n_data = int(mesh.shape[DATA_AXIS])

    def round_batch(self, batch_size: int) -> int:
        """Smallest multiple of the data-axis size >= ``batch_size``."""
        bs = int(batch_size)
        return ((bs + self.n_data - 1) // self.n_data) * self.n_data

    def replicate(self, tree: Any) -> Any:
        """Replicate a parameter pytree over every mesh device."""
        return jax.device_put(tree, NamedSharding(self.mesh, P()))

    def put(self, arr: Any, batch_axis: int = 0) -> jax.Array:
        """Place ``arr`` with its batch axis sharded over ``data``.

        ``batch_axis=1`` serves the estimators' superbatch layouts
        ``[S, bs, ...]`` — ``lax.map`` iterates the leading S axis, each
        step's ``[bs, ...]`` slice runs data-parallel.
        """
        ndim = getattr(arr, "ndim", None)
        if ndim is None:
            import numpy as np

            arr = np.asarray(arr)
            ndim = arr.ndim
        spec = [None] * ndim
        spec[batch_axis] = DATA_AXIS
        return jax.device_put(arr, NamedSharding(self.mesh, P(*spec)))


__all__ = ["DataParallel"]
