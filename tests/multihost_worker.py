"""Worker for the 2-process multihost test (spawned by test_multihost.py).

Simulates a 2-host pod on CPU: each process owns 4 virtual devices, joins a
TCP coordinator, builds the global (data, model) mesh, loads its local
batch slice, and reduces across hosts via a jitted global sum — the DCN
role of SURVEY.md §2.11 without a multi-host cluster."""
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")

import pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from himo_tpu.parallel import multihost

multihost.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == nproc * 4, len(jax.devices())

import numpy as np
import jax.numpy as jnp

mesh = multihost.global_mesh()
assert mesh.devices.size == nproc * 4

global_batch = 8
sl = multihost.host_local_batch_slice(global_batch)
full = np.arange(global_batch, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
local = full[sl]
batch = multihost.make_global_batch(mesh, {"x": local})

@jax.jit
def global_sum(b):
    return jnp.sum(b["x"])

got = float(global_sum(batch))
want = float(full.sum())
assert abs(got - want) < 1e-5, (got, want)
print(f"proc {pid}: global sum OK {got}", flush=True)
