"""Data-parallel SSL training loop for the feed-forward flow models.

Implements the reference's SeFlow++ recipe (assets/slurm/ssl-train-av2.sh:31-34:
``model=deflowpp loss_fn=seflowppLoss batch_size=8 epochs=12 lr=6e-5`` with
StepLR(3, 0.5) and 4-GPU DDP) as one SPMD program:

- one jitted ``train_step`` whose batch inputs carry a ``NamedSharding`` over
  the mesh's ``data`` axis while params stay replicated — XLA inserts the
  gradient all-reduce (NCCL on GPUs; no DDP wrapper);
- frames padded to a fixed point budget, so one program serves every batch;
- host-side batch building threads ahead of the device (double-buffered);
- .npz checkpoints with top-k retention + StepLR via optax schedule.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from himo_tpu.core.transforms import rigid_flow  # numpy: host prep must not dispatch per-op to the device
from himo_tpu.core.transforms import relative_pose, transform_points
from himo_tpu.data.dataset import SceneFlowDataset
from himo_tpu.models.feedforward import SceneFlowNet, make_model
from himo_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from himo_tpu.training.checkpoints import CheckpointManager
from himo_tpu.training.losses import SSLLossWeights, seflowpp_loss
from himo_tpu.utils.logging import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = "seflowpp"
    batch_size: int = 8
    epochs: int = 12
    lr: float = 6e-5
    step_lr_epochs: int = 3
    step_lr_gamma: float = 0.5
    # Conditioning (himo_tpu additions to the reference recipe — measured to
    # matter in the few-step regime; reference-parity run: warmup_steps=0,
    # grad_clip=0). Warmup is CAPPED at 10% of the run so short runs aren't
    # spent entirely on the ramp (a 96-step 12-epoch run with warmup=100
    # never reached the target lr and still had to converge).
    warmup_steps: int = 100  # linear lr warmup from 0 (capped at run/10)
    grad_clip: float = 2.0  # global-norm clip, 0 = off
    num_points: int = 65536  # fixed per-frame point budget
    loss_points: int = 16384  # chamfer-term sample size (0 = full cloud)
    num_clusters: int = 64
    max_dist: float = 2.0
    # Wider truncation for the dynamic-only chamfer term (fast objects move
    # 2.5-3.4 m/frame, beyond the classic 2 m radius; the dynamic masks on
    # both sides keep background out of the wider search). None = max_dist.
    dynamic_max_dist: Optional[float] = 5.0
    weights: SSLLossWeights = SSLLossWeights()
    seed: int = 0
    keep_checkpoints: int = 3
    log_every: int = 10
    val_every: int = 3  # epochs (reference: val_every=3)
    val_fraction: float = 0.1  # held-out frames when no val_dir is given


# ----------------------------------------------------------------- batches


def build_frame_arrays(
    data: Dict,
    num_points: int,
    num_frames: int,
    loss_points: int = 0,
    rng: Optional[np.random.Generator] = None,
    with_gt: bool = False,
) -> Dict:
    """One frame -> fixed-size training arrays (host, numpy).

    ``with_gt=True`` additionally emits the ground-truth RESIDUAL flow
    (``flow`` minus the pose-induced rigid flow) and its validity mask when
    the frame carries GT — the validation loop scores EPE against it."""

    def fit(arr, fill=0):
        out = np.full((num_points,) + arr.shape[1:], fill, dtype=arr.dtype)
        n = min(len(arr), num_points)
        out[:n] = arr[:n]
        return out, n

    xyz0 = data["pc0"][:, :3].astype(np.float32)
    xyz1 = data["pc1"][:, :3].astype(np.float32)
    pflow = rigid_flow(xyz0, data["pose0"], data["pose1"]).astype(np.float32)
    pc0_comp = xyz0 + pflow

    p0, n0 = fit(pc0_comp)
    p1, n1 = fit(xyz1)
    v0 = np.zeros(num_points, bool)
    v0[:n0] = ~data["gm0"][:n0]
    v1 = np.zeros(num_points, bool)
    v1[:n1] = ~data["gm1"][:n1]

    dyn0 = np.zeros(num_points, bool)
    if "ssl_dynamic" in data:
        dyn0[:n0] = data["ssl_dynamic"][:n0]
    cl0 = np.zeros(num_points, np.int32)
    if "ssl_cluster" in data:
        cl0[:n0] = data["ssl_cluster"][:n0]
    # pc1's dynamic mask = the successor frame's pc0-side SSL labels; when
    # absent every valid pc1 point stays a correspondence candidate.
    dyn1 = v1.copy()
    if "ssl_dynamic1" in data:
        dyn1 = np.zeros(num_points, bool)
        dyn1[:n1] = data["ssl_dynamic1"][:n1]
        dyn1 &= v1
    prior0 = np.zeros((num_points, 3), np.float32)
    prior_valid0 = np.zeros(num_points, bool)
    if "ssl_prior" in data:
        prior0[:n0] = data["ssl_prior"][:n0]
        prior_valid0[:n0] = data["ssl_prior_valid"][:n0]

    out = {
        "pc0": p0,
        "pc1": p1,
        "valid0": v0,
        "valid1": v1,
        "dynamic0": dyn0,
        "dynamic1": dyn1,
        "cluster0": cl0,
        "prior0": prior0,
        "prior_valid0": prior_valid0,
    }
    if loss_points and loss_points < num_points:
        rng = rng or np.random.default_rng(0)

        def sample(valid):
            pool = np.flatnonzero(valid)
            if len(pool) == 0:
                pool = np.array([0])
            return rng.choice(pool, size=loss_points, replace=len(pool) < loss_points).astype(
                np.int32
            )

        out["loss_idx0"] = sample(v0)
        out["loss_idx1"] = sample(v1)
    if with_gt:
        gt_res = np.zeros((num_points, 3), np.float32)
        gt_valid = np.zeros(num_points, bool)
        if "flow" in data:
            res = data["flow"][:, :3].astype(np.float32) - pflow
            g, ng = fit(res)
            gt_res = g
            gt_valid[:ng] = v0[:ng]
            if "flow_is_valid" in data:
                gt_valid[:ng] &= data["flow_is_valid"][:ng].astype(bool)
        out["gt_flow"] = gt_res
        out["gt_valid"] = gt_valid
    if num_frames >= 3:
        xyzp = data["pc_prev"][:, :3].astype(np.float32)
        # History sweep into the pc1 frame (prev -> next ego motion).
        rel = relative_pose(data["pose_prev"], data["pose1"])
        ph, nh = fit(transform_points(xyzp, rel).astype(np.float32))
        vh = np.zeros(num_points, bool)
        vh[:nh] = ~data["gm_prev"][:nh]
        out["pc_hist"] = ph
        out["valid_hist"] = vh
    return out


def split_train_val(num_items: int, batch_size: int, val_fraction: float):
    """Deterministic held-out split: every k-th frame goes to val (spread
    across scenes), sized to at least one batch when the dataset allows."""
    if val_fraction <= 0 or num_items < 2 * batch_size:
        return np.arange(num_items), np.array([], dtype=np.int64)
    n_val = max(batch_size, int(round(num_items * val_fraction)))
    n_val -= n_val % batch_size  # whole batches only
    stride = max(num_items // n_val, 2)
    val = np.arange(0, num_items, stride)[: n_val]
    train = np.setdiff1d(np.arange(num_items), val)
    return train, val


def batch_iterator(
    dataset: SceneFlowDataset,
    config: TrainConfig,
    num_frames: int,
    rng: np.random.Generator,
    prefetch: int = 2,
    indices: Optional[np.ndarray] = None,
    extra_keys: tuple = (),
) -> Iterator[Dict]:
    """Shuffled, threaded batch producer of stacked frame arrays."""
    pool = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    order = pool[rng.permutation(len(pool))] if rng is not None else pool
    n_batches = len(order) // config.batch_size
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        from himo_tpu import native

        preloaded: set = set()

        def preload_batch(b: int) -> None:
            """Warm the page cache for the NEXT batch's scene files (native
            io_uring reader) while this batch's frames decode — shuffled
            epochs touch scenes in random order, so cold reads otherwise
            land mid-epoch."""
            if not native.available():
                return
            idxs = order[b * config.batch_size : (b + 1) * config.batch_size]
            ix = (
                dataset.eval_index
                if getattr(dataset, "eval_index", None) is not None
                else dataset.data_index
            )
            sids = {ix[int(i)][0] for i in idxs} - preloaded
            if not sids:
                return
            preloaded.update(sids)
            try:
                native.preload_files(
                    [dataset.directory / f"{s}.h5" for s in sids]
                )
            except Exception:
                pass  # cache warming is best-effort

        for b in range(n_batches):
            if b + 1 < n_batches:
                preload_batch(b + 1)
            idxs = order[b * config.batch_size : (b + 1) * config.batch_size]
            frames = [
                build_frame_arrays(
                    dataset[int(i)],
                    config.num_points,
                    num_frames,
                    loss_points=config.loss_points,
                    rng=rng,
                    with_gt="gt" in extra_keys,
                )
                for i in idxs
            ]
            batch = {
                k: np.stack([f[k] for f in frames]) for k in frames[0]
            }
            q.put(batch)
        q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


# -------------------------------------------------------------- train step


def _frame_flow_and_loss(model: SceneFlowNet, config: TrainConfig, params, b):
    """Model flow + SSL loss terms for one (already padded) frame dict."""
    num_frames = model.config.num_frames
    sweeps = [b["pc0"], b["pc1"]]
    valids = [b["valid0"], b["valid1"]]
    if num_frames >= 3:
        sweeps.append(b["pc_hist"])
        valids.append(b["valid_hist"])
    prior_in = (
        jnp.where(b["prior_valid0"][:, None], b["prior0"], 0.0)
        if getattr(model.config, "prior_feat", False) and "prior0" in b
        else None
    )
    gate_logit = None
    dyn_logit = None
    if getattr(model.config, "gate_head", False):
        # soft_gate: training differentiates THROUGH the sigmoid gate (flow
        # losses can hold a gate open against a noisy BCE label); inference
        # uses the hard >0.5 cut (models/feedforward.py).
        flow, aux = model.apply(
            params, tuple(sweeps), tuple(valids), prior_in,
            with_aux=True, soft_gate=True,
        )
        gate_logit = aux.get("gate_logit")
        dyn_logit = aux.get("dyn_logit")
    else:
        flow = model.apply(params, tuple(sweeps), tuple(valids), prior_in)
    dynamic1 = b.get("dynamic1", b["valid1"])
    common = dict(
        num_clusters=config.num_clusters,
        weights=config.weights,
        max_dist=config.max_dist,
        dynamic_max_dist=config.dynamic_max_dist,
        prior0=b.get("prior0"),
        prior_valid0=b.get("prior_valid0"),
        gate_logit0=gate_logit,
    )
    if "loss_idx0" in b:
        from himo_tpu.training.losses import seflowpp_loss_sampled

        losses = seflowpp_loss_sampled(
            flow,
            b["pc0"],
            b["pc1"],
            b["valid0"],
            b["valid1"],
            b["dynamic0"],
            dynamic1,
            b["cluster0"],
            b["loss_idx0"],
            b["loss_idx1"],
            **common,
        )
    else:
        losses = seflowpp_loss(
            flow,
            b["pc0"],
            b["pc1"],
            b["valid0"],
            b["valid1"],
            b["dynamic0"],
            dynamic1,
            b["cluster0"],
            **common,
        )
    if dyn_logit is not None:
        from himo_tpu.training.losses import dyn_image_loss

        obj_pos = b["dynamic0"]
        if "prior_valid0" in b:
            obj_pos = obj_pos | b["prior_valid0"]
        dl = dyn_image_loss(
            dyn_logit, b["pc0"], b["valid0"], obj_pos, model.config.pillar
        )
        losses["dyn_img_loss"] = dl
        losses["total"] = losses["total"] + config.weights.dyn_img_loss * dl
    return flow, losses


def make_train_step(model: SceneFlowNet, config: TrainConfig, optimizer):
    def loss_fn(params, batch):
        losses = jax.vmap(
            lambda b: _frame_flow_and_loss(model, config, params, b)[1]
        )(batch)
        mean = {k: jnp.mean(v) for k, v in losses.items()}
        return mean["total"], mean

    @jax.jit
    def train_step(params, opt_state, batch):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step


def make_val_step(model: SceneFlowNet, config: TrainConfig):
    """Jitted validation: SSL loss sums + EPE sums vs GT residual flow.

    Returns per-batch SUMS (not means) so the caller can aggregate an exact
    mean over a val split of several batches."""

    @jax.jit
    def val_step(params, batch):
        def per_frame(b):
            flow, losses = _frame_flow_and_loss(model, config, params, b)
            err = jnp.linalg.norm(flow - b["gt_flow"], axis=1)
            gt_v = b["gt_valid"]
            return {
                "total": losses["total"],
                "epe_sum": jnp.sum(jnp.where(gt_v, err, 0.0)),
                "epe_count": jnp.sum(gt_v.astype(jnp.float32)),
            }

        out = jax.vmap(per_frame)(batch)
        return {
            "total_sum": jnp.sum(out["total"]),
            "frames": jnp.asarray(float(out["total"].shape[0])),
            "epe_sum": jnp.sum(out["epe_sum"]),
            "epe_count": jnp.sum(out["epe_count"]),
        }

    return val_step


def run_validation(
    val_step, params, dataset, val_indices, config, num_frames, mesh
) -> Dict:
    """Mean SSL loss + EPE over the val split (fixed rng => comparable
    across epochs)."""
    sums = {"total_sum": 0.0, "frames": 0.0, "epe_sum": 0.0, "epe_count": 0.0}
    for batch in batch_iterator(
        dataset,
        config,
        num_frames,
        rng=np.random.default_rng(1234),
        indices=val_indices,
        extra_keys=("gt",),
    ):
        batch = shard_batch(mesh, batch)
        out = val_step(params, batch)
        for k in sums:
            sums[k] += float(out[k])
    metrics = {
        "val_total": sums["total_sum"] / max(sums["frames"], 1.0),
        "val_epe": sums["epe_sum"] / max(sums["epe_count"], 1.0),
    }
    return metrics


def make_optimizer(config: TrainConfig, steps_per_epoch: int):
    """Adam + StepLR(step_lr_epochs, step_lr_gamma), with optional linear
    warmup and global-norm gradient clipping."""
    boundaries = {}
    for e in range(config.step_lr_epochs, config.epochs, config.step_lr_epochs):
        boundaries[e * max(steps_per_epoch, 1)] = config.step_lr_gamma
    step_lr = optax.piecewise_constant_schedule(config.lr, boundaries)
    total_steps = max(steps_per_epoch, 1) * config.epochs
    warmup_steps = min(config.warmup_steps, max(total_steps // 10, 1))
    if warmup_steps > 0:
        warmup = optax.linear_schedule(0.0, config.lr, warmup_steps)
        schedule = optax.join_schedules([warmup, step_lr], [warmup_steps])
    else:
        schedule = step_lr
    opt = optax.adam(schedule)
    if config.grad_clip > 0:
        opt = optax.chain(optax.clip_by_global_norm(config.grad_clip), opt)
    return opt, schedule


# -------------------------------------------------------------------- loop


def train(
    data_dir: str,
    config: TrainConfig = TrainConfig(),
    run_dir: str = "runs/seflowpp",
    mesh=None,
    wandb_mode: str = "disabled",
    model_overrides: Optional[dict] = None,
    resume: bool = True,
) -> Dict:
    """Full training run; returns final params and summary stats.

    ``resume=True`` restores the latest checkpoint in ``{run_dir}/ckpts`` and
    continues from its step (elastic restart after preemption — the failure-
    recovery role SURVEY.md §5 flags as absent in the reference).
    """
    model, model_config = make_model(config.model, **(model_overrides or {}))
    num_frames = model_config.num_frames
    dataset = SceneFlowDataset(
        data_dir,
        with_pc1=True,
        with_history=num_frames >= 3,
        extra_keys=("ssl_dynamic", "ssl_cluster", "ssl_prior", "ssl_prior_valid"),
        next_keys=("ssl_dynamic",),
    )
    if len(dataset) < config.batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} frames < batch_size {config.batch_size}"
        )

    mesh = mesh or make_mesh()
    rng = np.random.default_rng(config.seed)
    train_idx, val_idx = split_train_val(
        len(dataset), config.batch_size, config.val_fraction
    )
    steps_per_epoch = len(train_idx) // config.batch_size
    optimizer, schedule = make_optimizer(config, steps_per_epoch)

    from himo_tpu.models.feedforward import init_params

    params = init_params(model, jax.random.PRNGKey(config.seed), config.num_points)
    params = jax.device_put(params, replicated(mesh))
    opt_state = optimizer.init(params)
    train_step = make_train_step(model, config, optimizer)

    logger = MetricsLogger(
        run_dir,
        wandb_mode=wandb_mode,
        config={**dataclasses.asdict(config), "mesh": str(mesh.shape)},
    )
    has_val = len(val_idx) >= config.batch_size
    ckpts = CheckpointManager(
        f"{run_dir}/ckpts",
        keep=config.keep_checkpoints,
        best_metric="val_total" if has_val else None,
    )
    # Best-metric retention prunes non-best steps, so the resume point lives
    # in a separate recency-kept manager — otherwise a crash after epoch N
    # could resume from whichever OLD step happened to have the best val.
    ckpts_latest = (
        CheckpointManager(f"{run_dir}/ckpts_latest", keep=1) if has_val else ckpts
    )
    val_step = make_val_step(model, config) if has_val else None

    step = 0
    start_epoch = 0
    if resume:
        target = {"params": params, "opt_state": opt_state, "step": 0}
        latest_step, tree = ckpts_latest.restore_latest(target=target)
        if tree is None and ckpts_latest is not ckpts:
            latest_step, tree = ckpts.restore_latest(target=target)
        if tree is not None:
            params = jax.device_put(tree["params"], replicated(mesh))
            opt_state = tree["opt_state"]
            step = int(latest_step)
            # Continue at the epoch the checkpoint was taken in — resumed
            # runs train the REMAINING epochs, not all of them again.
            start_epoch = min(step // max(steps_per_epoch, 1), config.epochs)
            print(
                f"[train] resumed from step {step} (epoch {start_epoch}) "
                f"in {run_dir}/ckpts"
            )
    last_metrics: Dict[str, float] = {}
    val_metrics: Dict[str, float] = {}
    t0 = time.time()

    def validate_and_save():
        nonlocal val_metrics
        tree = {"params": params, "opt_state": opt_state, "step": step}
        if val_step is not None:
            val_metrics = run_validation(
                val_step, params, dataset, val_idx, config, num_frames, mesh
            )
            logger.log(val_metrics, step, prefix="val/")
            logger.print(val_metrics, step, prefix="val ")
            timing = ckpts.save(step, tree, metrics=dict(val_metrics))
            timing2 = ckpts_latest.save(step, tree)
            timing["drain_s"] += timing2["drain_s"]
            timing["dispatch_s"] += timing2["dispatch_s"]
        else:
            timing = ckpts.save(step, tree)
        # Compute/checkpoint overlap evidence: drain_s > 0 at this save
        # means the PREVIOUS async save was still writing while the train
        # steps since then (each visible with its own jsonl timestamp) ran.
        logger.log(timing, step, prefix="ckpt/")

    for epoch in range(start_epoch, config.epochs):
        for batch in batch_iterator(
            dataset, config, num_frames, rng, indices=train_idx
        ):
            batch = shard_batch(mesh, batch)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            step += 1
            if step % config.log_every == 0 or step == 1:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                last_metrics["lr"] = float(schedule(step))
                logger.log(last_metrics, step, prefix="train/")
                logger.print(last_metrics, step, prefix=f"epoch {epoch} ")
        if (epoch + 1) % config.val_every == 0 and epoch != config.epochs - 1:
            validate_and_save()
    validate_and_save()
    ckpts.close()
    if ckpts_latest is not ckpts:
        ckpts_latest.close()
    logger.close()
    return {
        "params": params,
        "steps": step,
        "seconds": time.time() - t0,
        "final_metrics": {**last_metrics, **val_metrics},
    }
