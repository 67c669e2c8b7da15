"""Multi-host runtime bootstrap + data-parallel placement helpers.

The reference runs strictly single-process (SURVEY.md §2.3); this module is
the runtime layer: one call bootstraps a multi-process JAX program, and the
placement helpers put host batches onto the mesh so estimator forwards run
data-parallel without per-call sharding plumbing.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, make_mesh

_initialized = False


def _multi_host_env() -> bool:
    import os

    return bool(os.environ.get("JAX_COORDINATOR_ADDRESS")) or int(
        os.environ.get("DEWI_NUM_PROCESSES", "1")
    ) > 1


def initialize_runtime(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap multi-process JAX (no-op when single-process).

    Called with explicit arguments, passes them to
    ``jax.distributed.initialize``.  Called with no arguments, it initializes
    from the environment only when ``JAX_COORDINATOR_ADDRESS`` (or
    ``DEWI_NUM_PROCESSES`` > 1) says the job spans processes; otherwise it
    is a deliberate no-op, so single-process programs never pay a
    coordinator timeout.  Safe to call more than once.  A failed
    initialization raises: a job that asked for several processes must not
    carry on as one.
    """
    global _initialized
    if _initialized:
        return
    if coordinator_address or (num_processes and num_processes > 1):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    elif _multi_host_env():
        jax.distributed.initialize()
        _initialized = True
    # Single-process: nothing to do; jax.devices() is already live.


def device_summary() -> dict:
    """Topology snapshot for logs/metrics."""
    devs = jax.devices()
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "n_devices": len(devs),
        "n_local_devices": jax.local_device_count(),
        "platform": devs[0].platform if devs else "none",
        "device_kind": devs[0].device_kind if devs else "none",
    }


def shard_batch(batch: np.ndarray, mesh: Mesh,
                pad_value: Any = 0) -> Any:
    """Place a host batch on the mesh, sharded over the data axis.

    Pads the leading axis up to a multiple of the data-axis size (XLA needs
    equal shards); returns ``(device_array, original_length)``.
    """
    n_data = mesh.shape[DATA_AXIS]
    batch = np.asarray(batch)
    n = batch.shape[0]
    rem = (-n) % n_data
    if rem:
        pad = np.full((rem,) + batch.shape[1:], pad_value, dtype=batch.dtype)
        batch = np.concatenate([batch, pad])
    spec = P(DATA_AXIS, *([None] * (batch.ndim - 1)))
    return jax.device_put(batch, NamedSharding(mesh, spec)), n


def default_mesh() -> Mesh:
    """All-devices data-parallel mesh (the standard DEWI layout)."""
    return make_mesh()


__all__ = ["initialize_runtime", "device_summary", "shard_batch", "default_mesh"]
