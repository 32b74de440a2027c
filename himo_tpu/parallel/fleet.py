"""Fleet-scale de-distortion: many scenes, one mesh, overlapped IO.

Replaces the reference's sequential per-frame loops (eval.py:281,
save_zip.py:112) with a sharded batch pipeline:

- frames pad to a fixed point budget and stack into batches of
  ``frames_per_step = batch_per_device * n_data_shards``;
- the jitted step (flow inference + fused de-skew) runs with the batch dim
  sharded over the mesh ``data`` axis — scenes are embarrassingly parallel,
  so no cross-device collectives are needed in inference;
- a host thread prefetches and pads the next batch while the device computes
  (double buffering across the PCIe boundary).

Used by the throughput bench and the batched ``save``/``save_zip`` paths.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from himo_tpu.core.transforms import rigid_flow  # numpy: host prep must not dispatch per-op to the device
from himo_tpu.core.transforms import relative_pose, transform_points
from himo_tpu.parallel.mesh import make_mesh, replicated, shard_batch


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    num_points: int = 65536
    batch_per_device: int = 1
    prefetch: int = 2
    sensor_dt: float = 0.1
    # Zero residual flow below this magnitude (m/frame). Static points' true
    # compensation is identically zero, but a feed-forward net trained on
    # few frames carries ~0.16 m of static noise that smears backgrounds at
    # de-skew time (measured: seg mIoU drops below raw). The HiMo eval only
    # scores instances >= 3 m/s (0.3 m/frame), so a 0.15-0.2 m gate cannot
    # touch a scored object. 0 = off.
    static_gate: float = 0.0
    # Host-prep worker threads. Frame prep is trivially cheap until the
    # prior-conditioned hybrid (seflowpp_trust) turns it into per-frame host
    # DBSCAN + matching (~0.2-1.2 s/frame of host work at 65k points),
    # far beyond the per-frame device time. Prep parallelizes across SCENES (the velocity-
    # continuity tracker is a per-scene sequential dependency) with a
    # bounded lookahead window so memory stays ~(window x frames/scene x
    # 5 MB).
    prep_threads: int = 8
    # Where prior-conditioned models get their cluster prior:
    # - 'auto': reuse on-disk ssl_prior when the label writers ran (their
    #   priors include the scene-start BACKCAST repair, which reads future
    #   frames — training-consistent but NON-CAUSAL), else compute fresh;
    # - 'fresh': always compute the CAUSAL per-pair prior in the producer
    #   (ignores ssl_prior) — the honest deployment/eval setting;
    # - 'disk': require ssl_prior (raise when absent) — offline labeling.
    prior_source: str = "auto"


def _pad(arr: np.ndarray, n: int, fill=0):
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    k = min(len(arr), n)
    out[:k] = arr[:k]
    return out, k


# Heavy float32 keys whose pad+stack defers to the native threaded packer
# at batch-assembly time (everything else is cheap bools/scalars).
_PACK_KEYS = ("pc0", "pc1", "dt0", "dt1", "pc_hist", "prior")


def frame_to_arrays(
    data: Dict,
    num_points: int,
    with_history: bool,
    defer_pack: bool = False,
    with_prior: bool = False,
    tracker=None,
    prior_source: str = "auto",
    with_dts: bool = False,
) -> Dict:
    """One dataset frame -> fixed-size arrays for the fleet step.

    ``defer_pack=True`` leaves the float32 keys UNPADDED (raw ``(n, C)``
    arrays); :func:`stack_fleet_batch` then pads+stacks them in one
    multithreaded pass through ``native.pack_frames``.

    Transfer diet: pc0 ships RAW with the (4, 4) relative ego pose, and the
    jitted step derives the pose flow on device — one fewer (N, 3) float32
    upload per frame. The host-side
    ``rigid_flow`` is only computed when the prior path needs the
    compensated cloud for clustering."""
    xyz0 = data["pc0"][:, :3].astype(np.float32)
    xyz1 = data["pc1"][:, :3].astype(np.float32)
    rel_pose = relative_pose(data["pose0"], data["pose1"]).astype(np.float32)
    lidar_dt = data["lidar_dt"].astype(np.float32)
    dt0 = lidar_dt.max() - lidar_dt

    fit = (lambda a: (a[:num_points], min(len(a), num_points))) if defer_pack \
        else (lambda a: _pad(a, num_points))
    p0, n0 = fit(xyz0)
    p1, n1 = fit(xyz1)
    v0 = np.zeros(num_points, bool)
    v0[:n0] = ~data["gm0"][:n0]
    v1 = np.zeros(num_points, bool)
    v1[:n1] = ~data["gm1"][:n1]
    out = {
        "pc0": p0,
        "pc1": p1,
        "valid0": v0,
        "valid1": v1,
        "rel_pose": rel_pose,
        "dt0": fit(dt0)[0],
        "num_real": n0,
        "num_total": len(xyz0),  # original cloud size (may exceed the budget)
    }
    if with_dts:
        # pc1 capture times for the refine head's de-smeared matching
        # (ops/refine.py); pc0's come free — the device inverts dt0 back
        # (lidar_dt = dt0.max() - dt0), so only ONE extra (N,) f32 ships.
        dt1_raw = data.get("lidar_dt1")
        if dt1_raw is None:
            dt1_raw = np.zeros(len(xyz1), np.float32)
        out["dt1"] = fit(np.asarray(dt1_raw, np.float32))[0]
    if with_history:
        xyzp = data["pc_prev"][:, :3].astype(np.float32)
        rel = relative_pose(data["pose_prev"], data["pose1"])
        ph, nh = fit(transform_points(xyzp, rel).astype(np.float32))
        vh = np.zeros(num_points, bool)
        vh[:nh] = ~data["gm_prev"][:nh]
        out["pc_hist"] = ph
        out["valid_hist"] = vh
    if with_prior:
        use_disk = prior_source in ("auto", "disk") and "ssl_prior" in data
        if prior_source == "disk" and "ssl_prior" not in data:
            raise ValueError(
                "prior_source='disk' but the frame carries no ssl_prior — "
                "run the label writers first or use 'auto'/'fresh'"
            )
        if use_disk:
            # Training data already carries the label writer's priors —
            # including the measured-velocity slow-mover recovery and the
            # scene-start backcast repair (which reads FUTURE frames:
            # training-consistent but non-causal; use prior_source='fresh'
            # for causal evaluation) — so the host DBSCAN is skipped.
            prior_full = np.asarray(data["ssl_prior"], np.float32)
            if "ssl_prior_valid" in data:
                pv = np.asarray(data["ssl_prior_valid"], bool)
                prior_full = np.where(pv[:, None], prior_full, 0.0)
        else:
            # Fresh data: the verified cluster translation prior, computed
            # at FULL resolution (host DBSCAN in the prefetch thread) with
            # the same de-smeared matcher + per-scene velocity-continuity
            # tracker the label writers use (min_norm=0: the flagship's
            # residual composition wants slow movers too, unlike the
            # optimization seeds that only need what chamfer can't reach).
            from himo_tpu.models.nsfp import cluster_prior_flow

            pflow = rigid_flow(
                xyz0, data["pose0"], data["pose1"]
            ).astype(np.float32)
            comp_full = xyz0 + pflow
            prior_full = np.asarray(
                cluster_prior_flow(
                    comp_full, xyz1, ~np.asarray(data["gm0"], bool),
                    ~np.asarray(data["gm1"], bool),
                    min_norm=0.0,
                    dt0=np.asarray(lidar_dt),
                    dt1=data.get("lidar_dt1"),
                    tracker=tracker,
                    pose1=data.get("pose1"),
                )
            )
        out["prior"] = fit(prior_full.astype(np.float32))[0]
    return out


def stack_fleet_batch(frames: List[Dict], num_points: int) -> Dict:
    """Stack per-frame dicts into batch arrays; float32 keys go through the
    native threaded packer when the frames were built with
    ``defer_pack=True`` (raw arrays), numpy otherwise."""
    from himo_tpu import native

    out = {}
    for k in frames[0]:
        if k in ("num_real", "num_total"):
            continue
        vals = [f[k] for f in frames]
        if (
            k in _PACK_KEYS
            and native.available()
            and any(len(v) != num_points for v in vals)
        ):
            flat = [v.reshape(len(v), -1) for v in vals]
            packed, _ = native.pack_frames(flat, num_points)
            out[k] = packed.reshape((len(vals), num_points) + vals[0].shape[1:])
        else:
            out[k] = np.stack(vals)
    return out


def make_fleet_step(model, params, config: FleetConfig, outputs=None):
    """Jitted batched step: flow inference + de-skew -> comp_dis, refined.

    ``outputs`` (subset of {"comp_dis", "refined", "flow", "residual"},
    None = all) trims the device->host readback: every returned (N, 3)
    array crosses PCIe, and fleet_save only consumes ``flow``. ``residual``
    is the network's flow (the de-skew's ``F``); ``flow`` adds the ego
    motion."""
    num_frames = model.config.num_frames

    def one(params, frame):
        # Pose flow on DEVICE from the (4, 4) relative ego pose: pc0 ships
        # raw, saving one (N, 3) f32 upload per frame. HIGHEST precision —
        # TF32 rounding of ~50 m coordinates would cost centimeters.
        rel = frame["rel_pose"]
        xyz0 = frame["pc0"]
        pose_flow = (
            jnp.einsum(
                "nc,rc->nr", xyz0, rel[:3, :3],
                precision=jax.lax.Precision.HIGHEST,
            )
            + rel[:3, 3][None, :]
            - xyz0
        )
        pc0_comp = xyz0 + pose_flow
        sweeps = [pc0_comp, frame["pc1"]]
        valids = [frame["valid0"], frame["valid1"]]
        if num_frames >= 3:
            sweeps.append(frame["pc_hist"])
            valids.append(frame["valid_hist"])
        dts = None
        if getattr(model.config, "refine_head", False) and "dt1" in frame:
            # dt0 ships as compensation weights (max - capture time);
            # invert on device — padded rows are 0 and never raise the max.
            dts = (jnp.max(frame["dt0"]) - frame["dt0"], frame["dt1"])
        residual = model.apply(
            params, tuple(sweeps), tuple(valids), frame.get("prior"),
            dts=dts,
        )
        if config.static_gate > 0:
            mag = jnp.linalg.norm(residual, axis=1, keepdims=True)
            residual = jnp.where(mag >= config.static_gate, residual, 0.0)
        comp_dis = residual * (frame["dt0"] / config.sensor_dt)[:, None]
        comp_dis = jnp.where(frame["valid0"][:, None], comp_dis, 0.0)
        # The de-skewed cloud lives in the ORIGINAL ego0 frame:
        # xyz0 + comp_dis — matching core.deskew / reference refine_pts.
        out = {
            "comp_dis": comp_dis,
            "refined": xyz0 + comp_dis,
            "flow": pose_flow + residual,
            "residual": residual,
        }
        if outputs is not None:
            out = {k: v for k, v in out.items() if k in outputs}
        return out

    @jax.jit
    def step(params, batch):
        return jax.vmap(one, in_axes=(None, 0))(params, batch)

    return step


def run_fleet(
    dataset,
    model,
    params,
    mesh=None,
    config: FleetConfig = FleetConfig(),
    consumer: Optional[Callable[[int, Dict, Dict], None]] = None,
    outputs=None,
) -> Dict[str, float]:
    """De-distort every frame of ``dataset`` across the mesh.

    ``consumer(frame_index, host_arrays, outputs)`` receives per-frame
    results (already trimmed to real points) for writing; ``None`` measures
    throughput only. ``outputs`` restricts which arrays come back from the
    device (see make_fleet_step — readback bandwidth is the e2e cost).
    """
    mesh = mesh or make_mesh()
    n_shards = mesh.devices.shape[0]
    per_step = config.batch_per_device * n_shards
    with_history = model.config.num_frames >= 3
    step = make_fleet_step(model, params, config, outputs=outputs)

    q: "queue.Queue" = queue.Queue(maxsize=config.prefetch)
    stop = object()

    from himo_tpu import native

    defer_pack = native.available()
    with_prior = bool(getattr(model.config, "prior_feat", False))
    with_dts = bool(getattr(model.config, "refine_head", False))

    def producer():
        ix = (
            dataset.eval_index
            if getattr(dataset, "eval_index", None) is not None
            else dataset.data_index
        )
        # Contiguous per-scene index runs, in dataset order.
        scenes: List[List[int]] = []
        for i in range(len(dataset)):
            if scenes and ix[scenes[-1][-1]][0] == ix[i][0]:
                scenes[-1].append(i)
            else:
                scenes.append([i])

        def prep_scene(idxs: List[int]) -> List[Tuple[int, Dict]]:
            """One worker owns a whole scene: the h5 file is touched by a
            single thread, io_uring pre-warms it, and the velocity-
            continuity tracker sees the scene's frames in order."""
            if defer_pack:
                try:
                    native.preload_files(
                        [dataset.directory / f"{ix[idxs[0]][0]}.h5"]
                    )
                except Exception:
                    pass  # cache warming is best-effort
            tracker = None
            out = []
            for i in idxs:
                data = dataset[i]
                if (
                    with_prior
                    and tracker is None
                    and (
                        config.prior_source == "fresh"
                        or "ssl_prior" not in data
                    )
                ):
                    from himo_tpu.models.icp_flow import ClusterTracker

                    tracker = ClusterTracker()
                out.append(
                    (
                        i,
                        frame_to_arrays(
                            data, config.num_points, with_history,
                            defer_pack=defer_pack, with_prior=with_prior,
                            tracker=tracker,
                            prior_source=config.prior_source,
                            with_dts=with_dts,
                        ),
                    )
                )
            return out

        from concurrent.futures import ThreadPoolExecutor

        n_workers = max(1, int(config.prep_threads))
        window = n_workers + 2  # bounded lookahead (memory cap)
        buf: List[Tuple[int, Dict]] = []
        with ThreadPoolExecutor(n_workers) as ex:
            pending = [ex.submit(prep_scene, s) for s in scenes[:window]]
            next_scene = len(pending)
            while pending:
                fut = pending.pop(0)
                if next_scene < len(scenes):
                    pending.append(ex.submit(prep_scene, scenes[next_scene]))
                    next_scene += 1
                for item in fut.result():
                    buf.append(item)
                    if len(buf) == per_step:
                        q.put(buf)
                        buf = []
        if buf:
            # Pad the final partial batch by repeating its last frame.
            while len(buf) < per_step:
                buf.append((-1, buf[-1][1]))
            q.put(buf)
        q.put(stop)

    threading.Thread(target=producer, daemon=True).start()

    frames = 0
    points = 0
    start = time.perf_counter()

    def drain(pending) -> None:
        """Read back + consume one completed step (called AFTER the next
        step is dispatched, so the device computes batch k+1 while batch
        k's results cross PCIe)."""
        nonlocal frames, points
        item, out = pending
        if consumer is not None:
            out = jax.device_get(out)
            for b, (i, host) in enumerate(item):
                if i < 0:
                    continue
                n = host["num_real"]
                consumer(
                    i, host, {k: np.asarray(v[b][:n]) for k, v in out.items()}
                )
        for i, host in item:
            if i >= 0:
                frames += 1
                points += host["num_real"]

    pending = None
    while True:
        item = q.get()
        if item is stop:
            break
        stacked = stack_fleet_batch([f for _, f in item], config.num_points)
        out = step(params, shard_batch(mesh, stacked))
        if pending is not None:
            drain(pending)
        pending = (item, out)
    if pending is not None:
        if consumer is None:
            # Force completion of the last dispatched step.
            jax.tree.map(lambda x: np.asarray(x[0, 0]), pending[1])
        drain(pending)
    elapsed = time.perf_counter() - start
    return {
        "frames": frames,
        "points": points,
        "seconds": elapsed,
        "points_per_sec": points / max(elapsed, 1e-9),
        "mesh_shards": n_shards,
    }


def fleet_save(
    data_dir,
    model: str = "seflowpp",
    checkpoint: Optional[str] = None,
    params=None,
    output_key: Optional[str] = None,
    mesh=None,
    config: FleetConfig = FleetConfig(),
    model_overrides: Optional[Dict] = None,
    verbose: bool = True,
) -> Dict[str, float]:
    """Mesh-sharded ``save.py``: batched feed-forward inference across the
    device mesh with total flow written back under ``output_key`` — the
    public surface of the config-5 chain (sharded inference -> h5 write-back
    -> downstream eval). CLI: ``python -m himo_tpu.cli.save fleet=true``."""
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.schema import write_method_flow
    from himo_tpu.models.feedforward import make_model

    net, net_cfg = make_model(model, **(model_overrides or {}))
    if params is None:
        if checkpoint is None:
            raise ValueError("fleet_save needs checkpoint= or params=")
        from himo_tpu.training.checkpoints import load_checkpoint

        params = load_checkpoint(checkpoint)["params"]
    output_key = output_key or model
    mesh = mesh or make_mesh()
    # Checkpoint restores land on one device; inference wants replicas.
    params = jax.device_put(params, replicated(mesh))
    dataset = SceneFlowDataset(
        data_dir, with_pc1=True, with_history=net_cfg.num_frames >= 3,
        # Prior-conditioned flagships reuse on-disk SSL priors when the
        # label writers ran (training-consistent; see frame_to_arrays) and
        # need the successor sweep times for the de-smeared matcher when
        # they didn't.
        extra_keys=("ssl_prior", "ssl_prior_valid"),
        next_keys=("lidar_dt",),
    )
    # (scene_id, timestamp) per frame, matching run_fleet's iteration order.
    index = (
        dataset.eval_index
        if dataset.eval_index is not None
        else dataset.data_index
    )

    # Buffer flows and write AFTER the run: the producer thread prefetch-
    # reads the same scene .h5 files, and a concurrent h5py append handle
    # races HDF5 file locking. Flow fields are small (N x 3 f32 per frame).
    pending = {}

    def consumer(i, host, out):
        flow = out["flow"]
        n = int(host["num_total"])
        if n > len(flow):
            flow = np.concatenate(
                [flow, np.zeros((n - len(flow), 3), np.float32)]
            )
        pending[i] = flow[:n]

    stats = run_fleet(
        dataset, net, params, mesh=mesh, config=config, consumer=consumer,
        outputs=("flow",),  # the write-back needs nothing else off-device
    )
    for i, flow in sorted(pending.items()):
        scene_id, timestamp = index[i]
        write_method_flow(data_dir, scene_id, timestamp, output_key, flow)
    if verbose:
        print(
            f"{output_key}: {stats['frames']} frames, {stats['points']} points "
            f"across {stats['mesh_shards']} shards in {stats['seconds']:.2f}s "
            f"({stats['points_per_sec'] / 1e6:.2f} M pts/s)"
        )
    return stats
