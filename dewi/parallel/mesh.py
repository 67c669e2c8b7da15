"""Device mesh and sharding helpers.

The reference has no distributed execution at all (SURVEY.md §2.3) — this
layer is green-field design.  Conventions:

* axis ``"data"``  — corpus/document axis: index shards, signal batches.
* axis ``"model"`` — tensor-parallel axis for large signal backbones.

Collectives ride the interconnect between cards; ``jax.distributed.initialize`` extends
the same mesh across slices over DCN (multi-process launch).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    Defaults to all devices on the data axis — the natural layout for DEWI,
    where the corpus axis dominates and the backbones are small.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} != {len(devices)} devices"
        )
    arr = np.array(devices).reshape(n_data, n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh, rank: int = 2) -> NamedSharding:
    """Shard leading (document) axis across the data axis; replicate the rest."""
    spec = P(DATA_AXIS, *([None] * (rank - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, devices=jax.devices()[:1])
