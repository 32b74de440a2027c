#!/usr/bin/env python3
"""GPU smoke test: himo's main path at full width, checked against plain
references.

    python chip_smoke.py               # one GPU: kernels, inference + de-skew, SSL training
    python chip_smoke.py --four-cards  # four GPUs: data-parallel train step and
                                       # mesh-sharded fleet inference vs one GPU

Phases (one process; the first failed check raises and the script exits
non-zero without the result line):

1. device — fail unless JAX's first device is a GPU; print JAX, the card
   (``nvidia-smi`` name and power limit), XLA_FLAGS and the compile cache.
2. kernels — the NN search (``nn_distance_sq``, ``nn_argmin``,
   ``fused_masked_nn``) at the refine shape (4,096 x 8,192) and the loss
   shape (16,384 x 16,384) against a float64 KD-tree; pillar
   ``scatter_max``/``scatter_mean``/``gather_pillars`` at 65,536 points x 32
   channels into 512^2 pillars, forward and gradient, against numpy.
3. inference + de-skew — the fleet pipeline (``parallel.fleet.run_fleet``:
   host prep, batch packing, jitted flow + de-skew, readback) over synthetic
   scenes of ~65k points, ``seflowpp`` at 512^2 / 0.2 m, 3 sweeps, batch 8,
   bfloat16. The scenes are held in memory (``SceneFlowDataset(scenes=)``);
   the .h5 reader and writer around this path are not exercised. Checks:
   de-skewed cloud == pc + F/0.1*dt0 in numpy; float32 GPU flow vs the
   in-process CPU device (``seflowpp_noprior`` max abs, ``seflowpp`` share
   of points off by > 1 cm).
4. SSL training — ``make_train_step`` with the recipe's optimizer (Adam,
   lr 6e-5) for 5 steps on 8 full-width frames; the loss must be finite and
   fall; one float32 step's loss vs the CPU at a CPU-sized width.

The last line of standard output is the result JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

NUM_POINTS = 65536
BATCH = 8
CHANNELS = 32
BACKGROUND = 64000  # synthetic scene background points (+ ~800 object points)
LOSS_POINTS = 16384
NN_SHAPES = (("refine", (4096, 8192)), ("loss", (16384, 16384)))
# Data-parallel vs one-card gradient (grad_agreement), about 10x the rounding
# reading on an H100 at full width: the mean of the gradients of a batch's
# four quarters vs the batch's own differs by 8e-5 over the whole tree and
# 1.2e-3 in the worst leaf (UNet conv kernels, whose sums over 8 x 512^2
# positions cancel heavily); one quarter alone, as a missing all-reduce
# would leave it, differs by 0.19 and 0.94.
GRAD_REL_LIMIT = 1e-3
GRAD_LEAF_LIMIT = 1e-2
CARD = "unknown card"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not bool(ok):
        raise AssertionError(msg)
    log(f"  ok: {msg}")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def timed(fn, *args, repeat: int = 5):
    """(result, median seconds) of ``fn(*args)`` after one warm call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeat):
        t = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return out, float(np.median(times))


def compile_timed(jitted, *args):
    """(compiled, seconds to lower + compile)."""
    t = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[phase] {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(
                f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f} s wall "
                f"({CARD})"
            )
        return False


# ------------------------------------------------------------------- data


def lidar_cloud(rng, n: int) -> np.ndarray:
    from himo_tpu.data.synthetic import lidar_like_cloud

    return lidar_like_cloud(rng, 1, n)[0]


def synthetic_scenes(num_scenes: int, seed: int):
    """{scene_id: frames}: 5 frames each, ~64k background points + objects
    (the fleet benchmark's scenes, in memory)."""
    from himo_tpu.data.synthetic import scene_frames

    return {
        f"scene_{i:03d}": scene_frames(
            num_frames=5, num_background=BACKGROUND, seed=seed + i
        )
        for i in range(num_scenes)
    }


def fleet_dataset(scenes):
    from himo_tpu.data.dataset import SceneFlowDataset

    return SceneFlowDataset(
        None, scenes=scenes, eval=True, with_pc1=True, with_history=True,
        next_keys=("lidar_dt",),
    )


# ---------------------------------------------------------------- kernels


def kdtree_nn(q: np.ndarray, r: np.ndarray, live=None):
    """float64 (d2 of best and second best, index of best) per query."""
    from scipy.spatial import cKDTree

    ids = np.arange(len(r)) if live is None else np.flatnonzero(live)
    d, i = cKDTree(r[ids].astype(np.float64)).query(q.astype(np.float64), k=2)
    return d**2, ids[i[:, 0]]


def check_nn(label, d2, idx, ref_d2, ref_idx):
    d2 = np.asarray(d2, np.float64)
    err = np.abs(d2 - ref_d2[:, 0])
    bad = err > 1e-5 * np.maximum(ref_d2[:, 0], 1.0)
    check(not bad.any(), f"{label}: |d2 - d2_ref| <= 1e-5*max(d2_ref,1) "
          f"(max err {err.max():.3g} m^2)")
    if idx is not None:
        sep = (ref_d2[:, 1] - ref_d2[:, 0]) > 1e-4
        wrong = (np.asarray(idx) != ref_idx) & sep
        check(not wrong.any(), f"{label}: indices match where the reference "
              f"gap > 1e-4 m^2 ({int(sep.sum())}/{len(sep)} rows)")


def phase_kernels(results):
    import jax
    import jax.numpy as jnp

    from himo_tpu.ops.nn import (
        _MASK_BIG, fused_masked_nn, nn_argmin, nn_distance_sq, nn_search,
    )

    rng = np.random.default_rng(0)
    for label, (n, m) in NN_SHAPES:
        q = lidar_cloud(rng, n)
        r = lidar_cloud(rng, m)
        ref_d2, ref_idx = kdtree_nn(q, r)
        qd, rd = jnp.asarray(q), jnp.asarray(r)
        d2, t_d = timed(jax.jit(nn_distance_sq), qd, rd)
        check_nn(f"nn_distance_sq {label} {n}x{m}", d2, None, ref_d2, ref_idx)
        (d2, idx), t_a = timed(jax.jit(nn_argmin), qd, rd)
        check_nn(f"nn_argmin {label} {n}x{m}", d2, idx, ref_d2, ref_idx)

        # Masked variants: 92% valid, 30% dynamic on each side.
        v0, v1 = rng.random(n) < 0.92, rng.random(m) < 0.92
        y0, y1 = v0 & (rng.random(n) < 0.3), v1 & (rng.random(m) < 0.3)
        pen = lambda mask: jnp.where(jnp.asarray(mask), 0.0, _MASK_BIG)  # noqa: E731
        args = (qd, rd, pen(v0), pen(y0), pen(v1), pen(y1))
        outs, t_f = timed(jax.jit(fused_masked_nn), *args)
        refs = (kdtree_nn(q, r, v1), kdtree_nn(q, r, y1),
                kdtree_nn(r, q, v0), kdtree_nn(r, q, y0))
        for name, out, (rd2, ridx) in zip(
            ("q->r all", "q->r dyn", "r->q all", "r->q dyn"), outs, refs
        ):
            check_nn(f"fused_masked_nn {label} {name}", out, None, rd2, ridx)
        (dm, im), _ = timed(
            jax.jit(nn_search), qd, rd, jnp.stack([pen(v1), pen(y1)]), repeat=1
        )
        for p, (rd2, ridx) in enumerate(refs[:2]):
            check_nn(f"nn_search {label} penalty row {p}", dm[p], im[p], rd2, ridx)
        for name, t in (("nn_distance_sq", t_d), ("nn_argmin", t_a),
                        ("fused_masked_nn", t_f)):
            results[f"{name}_{label}_ms"] = t * 1e3
            log(f"  time {name} {n}x{m}: {t * 1e3:.3f} ms ({CARD})")

    # Pillar scatter / gather at the model's width.
    from himo_tpu.ops.voxelize import (
        PillarConfig, PillarGrid, gather_pillars, scatter_max, scatter_mean,
        voxelize_pillars,
    )

    cfg = PillarConfig()
    h, w = cfg.grid_shape
    pts = lidar_cloud(rng, NUM_POINTS)
    valid = np.arange(NUM_POINTS) < int(NUM_POINTS * 0.92)
    feats = rng.normal(size=(NUM_POINTS, CHANNELS)).astype(np.float32)
    wimg = rng.normal(size=(h, w, CHANNELS)).astype(np.float32)
    gpts = rng.normal(size=(NUM_POINTS, CHANNELS)).astype(np.float32)
    grid = voxelize_pillars(jnp.asarray(pts), jnp.asarray(valid), cfg)
    pid = np.asarray(grid.pillar_ids)
    inr = np.asarray(grid.in_range)
    hw = h * w
    live = pid[inr]

    mx_ref = np.full((hw, CHANNELS), -np.inf, np.float32)
    np.maximum.at(mx_ref, live, feats[inr])
    mx_ref[~np.isfinite(mx_ref)] = 0.0
    cnt = np.bincount(live, minlength=hw).astype(np.float64)
    sums = np.zeros((hw, CHANNELS), np.float64)
    np.add.at(sums, live, feats[inr].astype(np.float64))
    mean_ref = sums / np.maximum(cnt, 1.0)[:, None]
    wflat = wimg.reshape(hw, CHANNELS)

    arrays = tuple(grid[:3])

    def on_grid(fn):
        """jit ``fn(x, grid)`` with the grid's arrays passed as arguments (a
        closure would bake them into the program as constants)."""
        run = jax.jit(lambda x, a: fn(x, PillarGrid(*a, grid.grid_shape)))
        return lambda x: run(x, arrays)

    def loss_of(op):
        return on_grid(jax.value_and_grad(lambda f, g: jnp.sum(op(f, g) * wimg)))

    img_mx = np.asarray(on_grid(scatter_max)(feats))
    check(np.array_equal(img_mx.reshape(hw, CHANNELS), mx_ref),
          "scatter_max 65536x32 -> 512^2 equals numpy exactly")
    _, g_mx = loss_of(scatter_max)(feats)
    win = (feats == mx_ref[np.minimum(pid, hw - 1)]) & inr[:, None]
    g_ref = np.where(win, wflat[np.minimum(pid, hw - 1)], 0.0)
    check(np.array_equal(np.asarray(g_mx), g_ref),
          "scatter_max gradient equals numpy exactly")
    img_mean = np.asarray(on_grid(scatter_mean)(feats))
    # rtol 1e-5: atomic adds sum in a run-dependent order; atol 1e-6 covers
    # pillar sums that cancel to ~0 (float32 rounding of O(1) summands).
    np.testing.assert_allclose(img_mean.reshape(hw, CHANNELS), mean_ref,
                               rtol=1e-5, atol=1e-6)
    log("  ok: scatter_mean matches numpy (rtol 1e-5)")
    _, g_mean = loss_of(scatter_mean)(feats)
    safe = np.minimum(pid, hw - 1)
    g_ref = np.where(inr[:, None], wflat[safe] / np.maximum(cnt[safe], 1)[:, None], 0)
    np.testing.assert_allclose(np.asarray(g_mean), g_ref, rtol=1e-5, atol=1e-6)
    log("  ok: scatter_mean gradient matches numpy (rtol 1e-5)")
    back = np.asarray(on_grid(gather_pillars)(wimg))
    check(np.array_equal(back, np.where(inr[:, None], wflat[safe], 0.0)),
          "gather_pillars equals numpy exactly")
    g_img = on_grid(jax.grad(lambda i, g: jnp.sum(gather_pillars(i, g) * gpts)))(wimg)
    g_ref = np.zeros((hw, CHANNELS), np.float64)
    np.add.at(g_ref, live, gpts[inr].astype(np.float64))
    np.testing.assert_allclose(np.asarray(g_img).reshape(hw, CHANNELS), g_ref,
                               rtol=1e-5, atol=1e-6)
    log("  ok: gather_pillars gradient matches numpy (rtol 1e-5)")

    # The model's pillar pooling: 3 sweeps x batch 8, forward and backward.
    sweeps = [lidar_cloud(rng, NUM_POINTS) for _ in range(3)]
    vb = jnp.asarray(np.broadcast_to(valid, (BATCH, NUM_POINTS)))
    pb = [jnp.asarray(np.broadcast_to(s, (BATCH,) + s.shape)) for s in sweeps]
    fb = [jnp.asarray(rng.normal(size=(BATCH, NUM_POINTS, CHANNELS)), jnp.float32)
          for _ in range(3)]

    def pool(fs, ps, v):
        grids = [voxelize_pillars(p, v, cfg) for p in ps]
        return [scatter_max(f, g) for f, g in zip(fs, grids)]

    fwd = jax.jit(jax.vmap(pool))
    bwd = jax.jit(jax.grad(lambda fs, ps, v: sum(
        jnp.sum(i) for i in jax.vmap(pool)(fs, ps, v))))
    _, t_fwd = timed(fwd, fb, pb, vb)
    _, t_bwd = timed(bwd, fb, pb, vb)
    results["scatter3_b8_fwd_ms"] = t_fwd * 1e3
    results["scatter3_b8_fwd_bwd_ms"] = t_bwd * 1e3
    log(f"  time scatter_max 3 sweeps x b8 x 65536x32 -> 512^2: "
        f"fwd {t_fwd * 1e3:.3f} ms, fwd+bwd {t_bwd * 1e3:.3f} ms ({CARD})")


# -------------------------------------------------------------- inference


def model_and_params(name: str, dtype: str, seed: int = 0):
    import jax

    from himo_tpu.models.feedforward import init_params, make_model

    model, config = make_model(name, dtype=dtype)
    params = init_params(model, jax.random.PRNGKey(seed), num_points=1024)
    return model, config, params


def one_frame_batch(dataset, config, fleet_cfg, index: int = 0):
    from himo_tpu.parallel.fleet import frame_to_arrays, stack_fleet_batch

    host = frame_to_arrays(
        dataset[index], fleet_cfg.num_points, config.num_frames >= 3,
        with_dts=bool(config.refine_head),
    )
    return stack_fleet_batch([host], fleet_cfg.num_points)


def gpu_vs_cpu_flow(name, dataset, fleet_cfg):
    """Residual flow of frame 0 in float32-highest on the GPU and on the
    in-process CPU device, same params."""
    import jax

    from himo_tpu.parallel.fleet import make_fleet_step

    model, config, params = model_and_params(name, "float32")
    batch = one_frame_batch(dataset, config, fleet_cfg)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        step = make_fleet_step(model, params, fleet_cfg, outputs=("residual",))
        t = time.perf_counter()
        gpu = np.asarray(step(jax.device_put(params), jax.device_put(batch))["residual"])
        t_gpu = time.perf_counter() - t
        t = time.perf_counter()
        host = np.asarray(
            step(jax.device_put(params, cpu), jax.device_put(batch, cpu))["residual"]
        )
        t_cpu = time.perf_counter() - t
    log(f"  {name} f32-highest frame: GPU {t_gpu:.1f} s, CPU {t_cpu:.1f} s "
        "(compile + run)")
    valid = batch["valid0"][0]
    return gpu[0][valid], host[0][valid]


def phase_inference(results):
    import jax

    from himo_tpu.parallel.fleet import FleetConfig, run_fleet

    scenes = synthetic_scenes(2, seed=0)
    dataset = fleet_dataset(scenes)
    check(len(dataset) == BATCH, f"{len(dataset)} eval frames = one batch of {BATCH}")
    model, config, params = model_and_params("seflowpp", "bfloat16")
    check(config.num_frames == 3 and config.instance_head and config.corr_volume
          and config.refine_head,
          f"seflowpp at {config.pillar.grid_shape} pillars, 3 sweeps, "
          "instance+corr+refine heads on")
    fleet_cfg = FleetConfig(num_points=NUM_POINTS, batch_per_device=BATCH)
    got = {}

    def consumer(i, host, out):
        got[i] = (host, out)

    params = jax.device_put(params)
    t = time.perf_counter()
    run_fleet(dataset, model, params, config=fleet_cfg, consumer=consumer,
              outputs=("comp_dis", "refined", "flow", "residual"))
    first = time.perf_counter() - t
    got.clear()
    stats = run_fleet(dataset, model, params, config=fleet_cfg, consumer=consumer,
                      outputs=("comp_dis", "refined", "flow", "residual"))
    # One batch: host prep, step and readback run one after another, so this
    # is the latency of a batch, not the pipeline's throughput (bench.py).
    log(f"  fleet seflowpp bf16: one batch of {stats['frames']} frames "
        f"({stats['points']} points), first pass (compile + run) {first:.1f} s, "
        f"second pass {stats['seconds']:.3f} s wall ({CARD})")
    results["fleet_first_batch_s"] = first
    results["fleet_batch_s"] = stats["seconds"]
    check(sorted(got) == list(range(BATCH)), "every frame came back")
    worst = 0.0
    for i, (host, out) in sorted(got.items()):
        n = host["num_real"]
        check(np.isfinite(out["flow"]).all() and np.isfinite(out["residual"]).all(),
              f"frame {i}: bf16 flow finite ({n} points)")
        pc = np.asarray(host["pc0"][:n], np.float32)
        dt0 = np.asarray(host["dt0"][:n], np.float32)
        v0 = np.asarray(host["valid0"][:n], bool)
        comp = out["residual"] * (dt0 / np.float32(0.1))[:, None]
        comp = np.where(v0[:, None], comp, np.float32(0.0))
        err = float(np.abs(out["comp_dis"] - comp).max())
        worst = max(worst, err)
        check(err <= 1e-6, f"frame {i}: comp_dis == F/0.1*dt0 (max err {err:.3g} m)")
        # The sum may be fused into one multiply-add on the device: allow
        # one float32 spacing of the coordinate (3.8e-6 m at 32-64 m).
        off = np.abs(out["refined"] - (pc + out["comp_dis"]))
        ulp = np.spacing(np.maximum(np.abs(pc), np.abs(out["refined"])))
        check((off <= ulp).all(),
              f"frame {i}: refined == pc + comp_dis within 1 ulp "
              f"(max {off.max():.3g} m)")
    results["deskew_max_err_m"] = worst

    fleet_1 = FleetConfig(num_points=NUM_POINTS, batch_per_device=1)
    g, c = gpu_vs_cpu_flow("seflowpp_noprior", dataset, fleet_1)
    err = float(np.abs(g - c).max())
    results["noprior_gpu_vs_cpu_max_m"] = err
    check(err <= 1e-3, f"seflowpp_noprior GPU vs CPU max |dflow| {err:.3g} m <= 1e-3")
    g, c = gpu_vs_cpu_flow("seflowpp", dataset, fleet_1)
    share = float((np.abs(g - c).max(axis=1) > 0.01).mean())
    results["seflowpp_gpu_vs_cpu_share_gt_1cm"] = share
    log(f"  seflowpp GPU vs CPU: {share:.6%} of points differ by > 1 cm")
    check(share <= 1e-3, "seflowpp GPU vs CPU share > 1 cm <= 0.1%")


# --------------------------------------------------------------- training


def train_batch(dataset, num_points: int, loss_points: int, frames: int, seed: int):
    """Fixed training batch from the synthetic frames: SSL dynamic / cluster
    labels taken from the ground truth."""
    from himo_tpu.core.transforms import rigid_flow
    from himo_tpu.training.trainer import build_frame_arrays

    rng = np.random.default_rng(seed)
    out = []
    for i in range(frames):
        d = dict(dataset[i % len(dataset)])
        res = d["flow"][:, :3] - rigid_flow(d["pc0"][:, :3], d["pose0"], d["pose1"])
        d["ssl_dynamic"] = (np.linalg.norm(res, axis=1) > 0.05) & ~d["gm0"]
        d["ssl_cluster"] = np.where(
            d["ssl_dynamic"], d["flow_instance_id"].astype(np.int32) % 64, 0
        )
        out.append(build_frame_arrays(
            d, num_points, 3, loss_points=loss_points, rng=rng
        ))
    return {k: np.stack([f[k] for f in out]) for k in out[0]}


def train_setup(pillar=None, num_points=None, loss_points=None, seed=0):
    import jax

    from himo_tpu.models.feedforward import init_params, make_model
    from himo_tpu.ops.voxelize import PillarConfig
    from himo_tpu.training.trainer import TrainConfig, make_optimizer

    num_points = num_points or NUM_POINTS
    loss_points = loss_points or LOSS_POINTS
    model, mcfg = make_model("seflowpp", pillar=pillar or PillarConfig())
    # The reference recipe: Adam at 6e-5, no warmup, no clipping.
    config = TrainConfig(num_points=num_points, loss_points=loss_points,
                         warmup_steps=0, grad_clip=0.0)
    optimizer, _ = make_optimizer(config, steps_per_epoch=1)
    params = init_params(model, jax.random.PRNGKey(seed), num_points=1024)
    return model, mcfg, config, optimizer, params


def phase_training(results):
    import jax

    from himo_tpu.ops.voxelize import PillarConfig
    from himo_tpu.training.trainer import make_train_step

    dataset = fleet_dataset(synthetic_scenes(2, seed=10))
    model, mcfg, config, optimizer, params = train_setup()
    log(f"  train at {mcfg.pillar.grid_shape} pillars, 3 sweeps")
    batch = jax.device_put(train_batch(dataset, NUM_POINTS, LOSS_POINTS, BATCH, seed=1))
    params = jax.device_put(params)
    opt_state = optimizer.init(params)
    step, t_c = compile_timed(make_train_step(model, config, optimizer),
                              params, opt_state, batch)
    losses, times = [], []
    for _ in range(5):
        t = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["total"]))
        times.append(time.perf_counter() - t)
    log(f"  seflowpp train step b{BATCH} x {NUM_POINTS} f32: compile {t_c:.1f} s, "
        f"step median {np.median(times) * 1e3:.1f} ms ({CARD}); losses {losses}")
    results["train_compile_s"] = t_c
    results["train_step_ms"] = float(np.median(times)) * 1e3
    check(np.isfinite(losses).all(), "train losses finite")
    check(losses[-1] < losses[0], f"loss falls over 5 steps "
          f"({losses[0]:.6f} -> {losses[-1]:.6f})")

    # One float32-highest step, GPU vs CPU, at a width the CPU runs quickly.
    small = PillarConfig(voxel_size=(0.8, 0.8))  # 128^2 over the same range
    model, _, config, optimizer, params = train_setup(small, 8192, 2048, seed=2)
    batch = train_batch(dataset, 8192, 2048, 2, seed=3)
    step = make_train_step(model, config, optimizer)
    cpu = jax.devices("cpu")[0]
    out = {}
    with jax.default_matmul_precision("highest"):
        for dev_name, dev in (("gpu", jax.devices()[0]), ("cpu", cpu)):
            p = jax.device_put(params, dev)
            b = jax.device_put(batch, dev)
            t = time.perf_counter()
            _, _, m = step(p, optimizer.init(p), b)
            out[dev_name] = float(m["total"])
            log(f"  small train step on {dev_name}: {time.perf_counter() - t:.1f} s "
                f"(compile + run), loss {out[dev_name]!r}")
    rel = abs(out["gpu"] - out["cpu"]) / abs(out["cpu"])
    results["train_loss_gpu_vs_cpu_rel"] = rel
    check(rel <= 1e-4, f"f32-highest train loss GPU vs CPU rel {rel:.3g} <= 1e-4")


# ------------------------------------------------------------- four cards


def gradient_probe():
    """An optax transformation that leaves the params as they are and keeps
    the gradient it was given as its state: ``make_train_step`` then returns
    its own (all-reduced) gradient, with no update's rounding on top."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def grad_agreement(got, ref):
    """(relative norm of ``got - ref`` over the whole tree, worst per-leaf
    relative error, that leaf's path). A leaf's error is relative to its own
    norm, floored at 1e-3 of the whole gradient's: leaves whose true
    gradient is zero (biases that a following GroupNorm cancels) carry
    rounding alone."""
    import jax

    pairs = [(jax.tree_util.keystr(k), np.asarray(g, np.float64), np.asarray(r, np.float64))
             for (k, g), r in zip(jax.tree_util.tree_leaves_with_path(got),
                                  jax.tree.leaves(ref))]
    norm = np.sqrt(sum(float(np.sum(r * r)) for _, _, r in pairs))
    diff = np.sqrt(sum(float(np.sum((g - r) ** 2)) for _, g, r in pairs))
    floor = 1e-3 * norm
    leaf = {k: float(np.linalg.norm(g - r)) / max(float(np.linalg.norm(r)), floor)
            for k, g, r in pairs}
    worst = max(leaf, key=leaf.get)
    return float(diff / norm), leaf[worst], worst


def phase_four_cards(results):
    import jax

    from himo_tpu.parallel.fleet import FleetConfig, run_fleet
    from himo_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from himo_tpu.training.trainer import make_train_step

    check(len(jax.devices()) == 4, f"4 GPUs visible ({jax.devices()})")
    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    dataset = fleet_dataset(synthetic_scenes(2, seed=20))

    # Data-parallel SSL step vs the same global batch on one card: the loss,
    # and the all-reduced gradient itself, read back through the step.
    model, _, config, _, params = train_setup()
    probe = gradient_probe()
    host_batch = train_batch(dataset, NUM_POINTS, LOSS_POINTS, BATCH, seed=4)
    step = make_train_step(model, config, probe)
    outs = {}
    with jax.default_matmul_precision("highest"):
        for label, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
            p = jax.device_put(params, replicated(mesh))
            b = shard_batch(mesh, host_batch)
            shards = {d.id for d in b["pc0"].sharding.device_set}
            t = time.perf_counter()
            _, grads, m = step(p, probe.init(p), b)
            loss = float(m["total"])
            log(f"  DP train step on {label} (batch over devices {sorted(shards)}): "
                f"{time.perf_counter() - t:.1f} s (compile + run), loss {loss!r}")
            outs[label] = (loss, jax.tree.map(np.asarray, grads))
    (l4, g4), (l1, g1) = outs["4 cards"], outs["1 card"]
    rel = abs(l4 - l1) / abs(l1)
    total, worst, leaf = grad_agreement(g4, g1)
    results.update(dp_loss_rel=rel, dp_grad_rel=total, dp_grad_leaf_rel=worst)
    check(rel <= 1e-4, f"DP loss 4 vs 1 card rel {rel:.3g} <= 1e-4")
    check(total <= GRAD_REL_LIMIT, f"DP gradient 4 vs 1 card: relative norm "
          f"{total:.3g} <= {GRAD_REL_LIMIT:g}")
    check(worst <= GRAD_LEAF_LIMIT, f"DP gradient 4 vs 1 card: worst leaf {leaf} "
          f"{worst:.3g} <= {GRAD_LEAF_LIMIT:g}")

    # Mesh-sharded fleet inference vs one card, same per-device batch.
    model, config, params = model_and_params("seflowpp_noprior", "float32")
    fleet_cfg = FleetConfig(num_points=NUM_POINTS, batch_per_device=2)
    flows = {}
    with jax.default_matmul_precision("highest"):
        for label, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
            got = {}

            def consumer(i, host, out, got=got):
                got[i] = out["flow"]

            t = time.perf_counter()
            stats = run_fleet(
                dataset, model, jax.device_put(params, replicated(mesh)),
                mesh=mesh, config=fleet_cfg, consumer=consumer, outputs=("flow",),
            )
            log(f"  fleet on {label}: {stats['frames']} frames over "
                f"{stats['mesh_shards']} shards in {time.perf_counter() - t:.1f} s "
                "(compile + run)")
            flows[label] = got
    err = max(float(np.abs(flows["4 cards"][i] - flows["1 card"][i]).max())
              for i in flows["1 card"])
    results["fleet_4v1_max_m"] = err
    check(sorted(flows["4 cards"]) == sorted(flows["1 card"]), "same frames back")
    check(err <= 1e-5, f"fleet flow 4 vs 1 card max |dflow| {err:.3g} m <= 1e-5")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-GPU paths and their 1-GPU comparisons")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); nothing run",
              file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from himo_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    CARD = card_line()
    log(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
        f"{len(devices)} device(s)")
    log(f"card (nvidia-smi name, power.limit): {CARD}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache: {cache}")

    results = {}
    t0 = time.perf_counter()
    if args.four_cards:
        with Phase("four cards: DP train step + sharded fleet vs one card"):
            phase_four_cards(results)
    else:
        with Phase("kernels vs plain references"):
            phase_kernels(results)
        with Phase("inference + de-skew at full width"):
            phase_inference(results)
        with Phase("SSL training at full width"):
            phase_training(results)
    log(f"total {time.perf_counter() - t0:.1f} s; card {CARD}")
    log("results " + json.dumps(results))
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
