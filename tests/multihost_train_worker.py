"""Worker for the 2-process multihost TRAIN test (spawned by
test_multihost.py).

The DDP role of the reference's 4-GPU recipe
(/root/reference/assets/slurm/ssl-train-av2.sh:3,31) on a simulated 2-host
pod: both processes join a TCP coordinator, build the global (data, model)
mesh, run ONE jitted sharded SSL train step on their local batch shards
(gradient all-reduce crosses the Gloo backend), verify the updated params are
bit-identical across hosts, then save (process 0 writes) and restore the
train state."""
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
ckpt_dir = sys.argv[4]

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
assert jax.process_count() == nproc

import numpy as np
import jax.numpy as jnp

mesh = multihost.global_mesh()

# Divisibility contract: a global batch that doesn't split across processes
# must raise, not silently truncate.
try:
    multihost.host_local_batch_slice(nproc * 4 + 1)
    raise SystemExit("expected ValueError for indivisible batch")
except ValueError:
    pass

from himo_tpu.models.feedforward import init_params, make_model
from himo_tpu.ops.voxelize import PillarConfig
from himo_tpu.training.trainer import TrainConfig, make_optimizer, make_train_step
from himo_tpu.parallel.mesh import replicated

config = TrainConfig(
    model="seflowpp", batch_size=8, num_points=512, loss_points=256, lr=1e-3
)
model, model_config = make_model(
    "seflowpp",
    pillar=PillarConfig(
        x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), voxel_size=(1.6, 1.6)
    ),
    depths=(8, 16),
    point_feat_dim=8,
    base_channels=8,
)
optimizer, _ = make_optimizer(config, steps_per_epoch=1)
params = init_params(model, jax.random.PRNGKey(0), config.num_points)
params = jax.device_put(params, replicated(mesh))
opt_state = optimizer.init(params)
train_step = make_train_step(model, config, optimizer)

# Global batch: deterministic content so both hosts agree on the full array;
# each host feeds only its local slice.
rng = np.random.default_rng(7)
gb = config.batch_size
full = {
    "pc0": rng.normal(scale=10, size=(gb, config.num_points, 3)).astype(np.float32),
    "pc1": rng.normal(scale=10, size=(gb, config.num_points, 3)).astype(np.float32),
    "valid0": np.ones((gb, config.num_points), bool),
    "valid1": np.ones((gb, config.num_points), bool),
    "dynamic0": np.zeros((gb, config.num_points), bool),
    "dynamic1": np.ones((gb, config.num_points), bool),
    "cluster0": np.zeros((gb, config.num_points), np.int32),
    "prior0": np.zeros((gb, config.num_points, 3), np.float32),
    "prior_valid0": np.zeros((gb, config.num_points), bool),
    "loss_idx0": np.tile(np.arange(config.loss_points, dtype=np.int32), (gb, 1)),
    "loss_idx1": np.tile(np.arange(config.loss_points, dtype=np.int32), (gb, 1)),
    "pc_hist": rng.normal(scale=10, size=(gb, config.num_points, 3)).astype(np.float32),
    "valid_hist": np.ones((gb, config.num_points), bool),
}
sl = multihost.host_local_batch_slice(gb)
local = {k: v[sl] for k, v in full.items()}
batch = multihost.make_global_batch(mesh, local)

params, opt_state, metrics = train_step(params, opt_state, batch)
total = float(metrics["total"])
assert np.isfinite(total), total

# DDP evidence: the post-step replicated params must be identical on every
# host (the gradient all-reduce crossed the process boundary).
leaves = jax.tree.leaves(params)
checksum = float(sum(jnp.sum(jnp.abs(leaf)) for leaf in leaves))
gathered = jax.experimental.multihost_utils.process_allgather(
    jnp.asarray([checksum])
)
assert np.allclose(np.asarray(gathered), checksum, rtol=1e-6), gathered

# Collective checkpoint save + restore across processes.
from himo_tpu.training.checkpoints import CheckpointManager

tree = {"params": params, "step": 1}
ckpts = CheckpointManager(ckpt_dir, keep=1)
ckpts.save(1, tree)
ckpts.close()

ckpts2 = CheckpointManager(ckpt_dir, keep=1)
step, restored = ckpts2.restore_latest(target={"params": params, "step": 0})
ckpts2.close()
assert int(step) == 1
for a, b in zip(jax.tree.leaves(restored["params"]), jax.tree.leaves(params)):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b))

print(f"proc {pid}: train step OK loss {total:.4f} checksum {checksum:.3f}", flush=True)
