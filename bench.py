"""Throughput benchmark: compensated points/sec of flow inference + de-skew.

Runs on one GPU (and fails without one): the SeFlow++-class pillar-UNet
flow inference + fused per-point de-skew, batch 8, bfloat16, everything
jitted.

The headline config is REFERENCE PARITY: a 512x512 pseudo-image at 0.2 m
voxels over [-51.2, 51.2] m (the reference training recipe,
assets/slurm/ssl-train-av2.sh:32), on clouds with LiDAR-like radial density
and ~92% valid points. Secondary numbers: the 256x256 @ 0.4 m grid, the net
without the instance and refine heads, and the host-inclusive fleet
pipeline (host prep, packing, device, readback) over in-memory synthetic
scenes, beside the fleet's own step alone on a device-resident batch.

Timing: host clock around calls that end in ``block_until_ready``, after a
warm-up call; the median of the repeats is reported with its spread.

Prints ONE JSON line naming the device it ran on.
"""

from __future__ import annotations

import json
import time

import numpy as np

BATCH = 8
NUM_POINTS = 65536
VALID_FRACTION = 0.92
REPEATS = 5


def measure(pillar_voxel: float, model_name: str = "seflowpp"):
    """(points/sec, spread of the step time in seconds) of the compute-only
    path at batch ``BATCH``."""
    import jax
    import jax.numpy as jnp

    from himo_tpu.data.synthetic import lidar_like_cloud
    from himo_tpu.models.feedforward import init_params, make_model
    from himo_tpu.ops.voxelize import PillarConfig

    pillar = PillarConfig(voxel_size=(pillar_voxel, pillar_voxel))
    model, _ = make_model(model_name, pillar=pillar, dtype="bfloat16")
    params = init_params(model, jax.random.PRNGKey(0), num_points=1024)

    def frame(params, pc0, pc1, pc_hist, valid, dt0):
        # dts feeds the refine head's de-smear (ops/refine.py) — part of
        # the deployment config, so the headline pays for it.
        flow = model.apply(
            params, (pc0, pc1, pc_hist), (valid, valid, valid), dts=(dt0, dt0),
        )
        return pc0 + flow * (dt0 / 0.1)[:, None]

    step = jax.jit(jax.vmap(frame, in_axes=(None, 0, 0, 0, 0, 0)))
    rng = np.random.default_rng(0)
    cloud = lambda: jnp.asarray(lidar_like_cloud(rng, BATCH, NUM_POINTS))  # noqa: E731
    pc0, pc1, pc_hist = cloud(), cloud(), cloud()
    n_valid = int(NUM_POINTS * VALID_FRACTION)
    valid = jnp.asarray(np.arange(NUM_POINTS) < n_valid)[None, :].repeat(BATCH, 0)
    dt0 = jnp.asarray(rng.uniform(0, 0.1, size=(BATCH, NUM_POINTS)), jnp.float32)
    args = (params, pc0, pc1, pc_hist, valid, dt0)

    jax.block_until_ready(step(*args))  # compile + warm-up
    times = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        jax.block_until_ready(step(*args))
        times.append(time.perf_counter() - start)
    med = float(np.median(times))
    return BATCH * n_valid / med, float(np.max(times) - np.min(times))


def measure_fleet_e2e(model_name: str = "seflowpp") -> dict:
    """Host-inclusive fleet throughput through ``parallel.fleet.run_fleet``
    (host prep and packing -> device flow inference + de-skew -> readback)
    over 12 scenes, 48 frames, 6 batches, beside the same jitted step alone
    on a device-resident batch.

    The scenes are synthetic and held in memory; the .h5 decode and
    write-back of ``fleet_save`` are not part of this number. The first
    pass warms the compile; the second is measured."""
    import jax

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.synthetic import scene_frames
    from himo_tpu.models.feedforward import init_params, make_model
    from himo_tpu.parallel.fleet import (
        FleetConfig, frame_to_arrays, make_fleet_step, run_fleet, stack_fleet_batch,
    )

    scenes = {
        f"scene_{i:03d}": scene_frames(num_frames=5, num_background=64000, seed=i)
        for i in range(12)
    }
    dataset = SceneFlowDataset(
        None, scenes=scenes, eval=True, with_pc1=True, with_history=True,
        next_keys=("lidar_dt",),
    )
    model, mcfg = make_model(model_name, dtype="bfloat16")
    params = jax.device_put(init_params(model, jax.random.PRNGKey(0), num_points=1024))
    config = FleetConfig(num_points=NUM_POINTS, batch_per_device=BATCH)

    def consumer(i, host, out):
        pass  # the readback happens; nothing is kept

    run_fleet(dataset, model, params, config=config, consumer=consumer,
              outputs=("flow",))
    stats = run_fleet(dataset, model, params, config=config, consumer=consumer,
                      outputs=("flow",))

    hosts = [
        frame_to_arrays(dataset[i], NUM_POINTS, True, with_dts=bool(mcfg.refine_head))
        for i in range(BATCH)
    ]
    batch = jax.device_put(stack_fleet_batch(hosts, NUM_POINTS))
    step = make_fleet_step(model, params, config, outputs=("flow",))
    jax.block_until_ready(step(params, batch))
    times = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        jax.block_until_ready(step(params, batch))
        times.append(time.perf_counter() - start)
    step_s = float(np.median(times))
    return {
        "points_per_sec": stats["points_per_sec"],
        "frames": stats["frames"],
        "seconds": stats["seconds"],
        "step_points_per_sec": sum(h["num_real"] for h in hosts) / step_s,
        "step_s": step_s,
    }


def main() -> dict:
    import jax

    from himo_tpu.utils.compile_cache import enable_compile_cache

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {device.platform}")
    enable_compile_cache()

    headline, spread = measure(0.2)  # 512x512 reference-parity grid
    secondary, _ = measure(0.4)  # 256x256
    noheads, _ = measure(0.2, model_name="seflowpp_noprior")
    fleet = measure_fleet_e2e()
    result = {
        "metric": "seflowpp_inference_deskew_points_per_sec_512grid",
        "value": round(headline / 1e6, 3),
        "unit": "Mpts/s",
        "step_spread_s": spread,
        "secondary_256": round(secondary / 1e6, 3),
        # The net without the instance and refine heads (the correlation
        # volume stays): the heads' cost is the gap to ``value``.
        "secondary_noheads_512": round(noheads / 1e6, 3),
        # Host-inclusive pass over 48 frames, and the same step alone on a
        # device-resident batch of 8: their gap is the host's share.
        "e2e_fleet_512": round(fleet["points_per_sec"] / 1e6, 3),
        "e2e_fleet_frames": fleet["frames"],
        "e2e_fleet_seconds": fleet["seconds"],
        "fleet_step_512": round(fleet["step_points_per_sec"] / 1e6, 3),
        "fleet_step_s": fleet["step_s"],
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
