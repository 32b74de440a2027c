"""Multi-host (pod / DCN) initialization & helpers.

Single-host usage needs nothing from here — `make_mesh()` over the local
GPUs. For multi-host fleets (several processes, each owning a subset of
the devices):

    from himo_tpu.parallel import multihost
    multihost.initialize()               # jax.distributed under the hood
    mesh = multihost.global_mesh()       # (data, model) over ALL devices

Data loading stays per-host: each process feeds its local shard of the
batch via :func:`host_local_batch_slice`, and
``jax.make_array_from_process_local_data`` assembles the global array.
Gradient all-reduces run over NVLink within a host and the network across
hosts — XLA places them from the sharding, no custom comm code (SURVEY.md
§2.11 / scaling-book recipe).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from himo_tpu.parallel.mesh import DATA_AXIS, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed; no-op when already initialized or
    single-process. On GPUs the coordinator address, process count and
    process id must be given.

    MUST run before anything touches the XLA backend — including
    ``jax.process_count()``/``jax.devices()`` — so the already-initialized
    check uses ``jax.distributed.is_initialized`` (backend-free)."""
    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError) as exc:
        # Single-process environments raise; that's fine.
        if num_processes not in (None, 1):
            raise
        print(f"[multihost] single-process mode ({exc})")


def global_mesh(model_parallel: int = 1):
    """Mesh over every device in the job (all hosts)."""
    return make_mesh(devices=jax.devices(), model_parallel=model_parallel)


def host_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process should load.

    Raises when the batch doesn't divide evenly — silently dropping the
    remainder frames would skew training without any visible signal."""
    count = jax.process_count()
    if global_batch % count:
        raise ValueError(
            f"global_batch={global_batch} not divisible by "
            f"process_count={count}; pad or resize the batch"
        )
    per_process = global_batch // count
    start = jax.process_index() * per_process
    return slice(start, start + per_process)


def make_global_batch(mesh, host_arrays):
    """Assemble process-local arrays into globally sharded jax.Arrays."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def one(x):
        sharding = NamedSharding(mesh, P(DATA_AXIS, *([None] * (np.ndim(x) - 1))))
        return jax.make_array_from_process_local_data(sharding, x)

    return jax.tree.map(one, host_arrays)
