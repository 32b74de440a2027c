"""Stage-cost profile of the end-to-end fleet path.

Decomposes a fleet_save pass over a synthetic .h5 dataset (12 scenes of 5
frames, ~65k points each) into its host/device stages, each measured
independently, so the gap between the host-inclusive and the compute-only
throughput attributes to named costs:

    python scripts/profile_fleet.py

Stages: h5 decode (dataset[i]), rigid_flow, frame_to_arrays (pad/masks),
stack_fleet_batch (native pack), host->device transfer (shard_batch +
device_put completion), jitted step, device->host readback, h5 write-back.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

NUM_POINTS = 65536
BATCH = 8


def main() -> None:
    import jax

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.synthetic import make_dataset
    from himo_tpu.models.feedforward import init_params, make_model
    from himo_tpu.parallel.fleet import (
        FleetConfig,
        frame_to_arrays,
        make_fleet_step,
        stack_fleet_batch,
    )
    from himo_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from himo_tpu.utils.profiling import Timer

    root = Path("/tmp/himo_fleet_bench")
    if not (root / "index_eval.pkl").exists():
        make_dataset(
            root, num_scenes=12, num_frames=5, num_background=64000, seed=0
        )
    model, _ = make_model("seflowpp", dtype="bfloat16")
    params = init_params(model, jax.random.PRNGKey(0), NUM_POINTS)
    config = FleetConfig(num_points=NUM_POINTS, batch_per_device=BATCH)
    mesh = make_mesh()
    params = jax.device_put(params, replicated(mesh))
    step = make_fleet_step(model, params, config)
    dataset = SceneFlowDataset(root, with_pc1=True, with_history=True)

    timer = Timer()
    n = len(dataset)
    print(f"{n} frames, {NUM_POINTS} pts budget, mesh {mesh.devices.shape}")

    # --- per-frame host stages (sequential, so each cost is clean) ---
    frames = []
    for i in range(n):
        with timer("h5_decode(dataset[i])"):
            data = dataset[i]
        with timer("rigid_flow"):
            from himo_tpu.core.transforms import rigid_flow

            rigid_flow(
                data["pc0"][:, :3].astype(np.float32),
                data["pose0"],
                data["pose1"],
            )
        with timer("frame_to_arrays"):
            frames.append(
                frame_to_arrays(data, NUM_POINTS, with_history=True)
            )

    # --- batch assembly + device round trips ---
    batches = []
    for b in range(0, n - BATCH + 1, BATCH):
        with timer("stack_fleet_batch"):
            batches.append(stack_fleet_batch(frames[b : b + BATCH], NUM_POINTS))

    # Warm the compile outside the timers.
    warm = step(params, shard_batch(mesh, batches[0]))
    jax.tree.map(np.asarray, warm)

    for batch in batches:
        with timer("host_to_device+step_dispatch"):
            sharded = shard_batch(mesh, batch)
            out = step(params, sharded)
        with timer("device_compute+readback"):
            out = jax.tree.map(np.asarray, out)

    # --- write-back (same volume fleet_save writes) ---
    from himo_tpu.data.schema import write_method_flow

    ix = dataset.data_index
    for i in range(n):
        with timer("h5_write_back"):
            write_method_flow(
                root, ix[i][0], ix[i][1], "profile_bench",
                np.zeros((NUM_POINTS, 3), np.float32),
            )

    timer.print_summary()
    total = sum(timer.totals.values())
    pts = n * NUM_POINTS
    print(f"\nsequential-sum total {total:.2f}s over {n} frames "
          f"({pts / total / 1e6:.3f} Mpts/s if nothing overlapped)")
    dev = timer.totals["device_compute+readback"]
    print(f"device share {dev:.2f}s -> host overhead {total - dev:.2f}s "
          f"({(total - dev) / total * 100:.0f}%)")


if __name__ == "__main__":
    main()
