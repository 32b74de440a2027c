"""Device mesh & sharding helpers.

The reference's only multi-device axis is 4-GPU DDP training
(assets/slurm/ssl-train-av2.sh:3; SURVEY.md §2.11). Here that is a named
mesh:

- ``data`` — scenes/frames batch axis (training DP and fleet inference);
  gradients all-reduce via jit-inserted psums (NCCL between GPUs).
- ``model`` — reserved axis for spatially sharding the pillar pseudo-image
  (beyond-memory grids); size 1 until needed.

The GPUs of one host reach each other all to all over NVLink, so the mesh
follows the algorithm alone: a flat list of devices. Everything routes
through ``jax.sharding.NamedSharding`` so the same code runs on one GPU
(trivial mesh), on several, and on the virtual CPU mesh of the tests.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """(data, model) mesh over the first ``n_devices`` devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.array(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis, replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Device-put a pytree of batched arrays with the batch dim sharded."""
    return jax.tree.map(
        lambda x: jax.device_put(x, data_sharding(mesh, np.ndim(x))), tree
    )
