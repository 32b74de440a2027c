"""Per-instance decomposition of the net-only flagship's error (round 5).

For every fast GT instance on the eval split: how much of it the instance
head covers (slot != -1), how much the gate opens, and where the error
lives — the pooled component mean vs the truth (bias of the net's
per-object estimate) vs the per-point scatter around it. Separates "the
net's object translation is off" from "the head failed to isolate the
object" — the two need different fixes.

    python scripts/flagship_diagnostic.py \
        [--root /tmp/av2_q18_s0] [--model seflowpp] [--min-speed 5]
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/av2_q18_s0")
    ap.add_argument("--model", default="seflowpp")
    ap.add_argument("--min-speed", type=float, default=5.0)
    ap.add_argument("--num-points", type=int, default=20480)
    ap.add_argument("--period", type=float, default=0.1)
    ap.add_argument("--limit", type=int, default=0, help="max frames (0=all)")
    args = ap.parse_args()

    import jax

    from himo_tpu.core.transforms import rigid_flow
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.models.feedforward import make_model
    from himo_tpu.parallel.fleet import frame_to_arrays
    from himo_tpu.training.checkpoints import CheckpointManager

    net, cfg = make_model(args.model)
    mgr = CheckpointManager(f"{args.root}/runs/{args.model}/ckpts")
    step, tree = mgr.restore_latest()
    params = tree["params"]
    print(f"restored {args.model} step {step}")

    dataset = SceneFlowDataset(
        args.root, with_pc1=True, with_history=cfg.num_frames >= 3, eval=True
    )

    @jax.jit
    def forward(params, f):
        sweeps = [f["pc0"], f["pc1"]]
        valids = [f["valid0"], f["valid1"]]
        if cfg.num_frames >= 3:
            sweeps.append(f["pc_hist"])
            valids.append(f["valid_hist"])
        return net.apply(
            params, tuple(sweeps), tuple(valids), with_aux=True
        )

    rows = []
    n_frames = min(len(dataset), args.limit) if args.limit else len(dataset)
    for i in range(n_frames):
        data = dataset[i]
        f = frame_to_arrays(data, args.num_points, cfg.num_frames >= 3)
        flow, aux = forward(params, {k: v for k, v in f.items()
                                     if not isinstance(v, int)})
        flow = np.asarray(flow)
        slot = np.asarray(aux["slot"])
        gate = np.asarray(aux["gate_logit"]) > 0
        n = f["num_real"]
        ego = rigid_flow(
            data["pc0"][:, :3].astype(np.float32), data["pose0"], data["pose1"]
        )
        truth = (np.asarray(data["flow"])[:n, :3] - ego[:n]).astype(np.float32)
        inst = np.asarray(data["flow_instance_id"])[:n]
        for iid in np.unique(inst[inst > 0]):
            m = inst == iid
            if m.sum() < 10:
                continue
            t = truth[m].mean(0)
            speed = float(np.linalg.norm(t)) / args.period
            if speed < args.min_speed:
                continue
            fl, sl, gt_ = flow[:n][m], slot[:n][m], gate[:n][m]
            err = np.linalg.norm(fl - truth[m], axis=1)
            # Majority slot = the component the head thinks this object is.
            maj = np.bincount(sl[sl >= 0] + 1).argmax() - 1 if (sl >= 0).any() else -1
            in_maj = sl == maj if maj >= 0 else np.zeros(len(sl), bool)
            pooled_err = (
                float(np.linalg.norm(fl[in_maj & gt_].mean(0) - t))
                if (in_maj & gt_).sum() >= 3
                else np.nan
            )
            rows.append(
                dict(
                    scene=data["scene_id"], frame=i, inst=int(iid),
                    speed=speed,
                    slot_cov=float((sl >= 0).mean()),
                    gate_open=float(gt_.mean()),
                    acc_s=float((err <= np.maximum(0.05, 0.05 * np.linalg.norm(truth[m], axis=1))).mean()),
                    err_mean=float(err.mean()),
                    pooled_bias=pooled_err,
                    n_slots=int(len(np.unique(sl[sl >= 0]))),
                )
            )

    print(f"{len(rows)} fast frame-instances")
    byspeed = defaultdict(list)
    for r in rows:
        b = "05-10" if r["speed"] < 10 else ("10-20" if r["speed"] < 20 else "20+")
        byspeed[b].append(r)
    for b in sorted(byspeed):
        rs = byspeed[b]
        def agg(k):
            vals = [r[k] for r in rs if not np.isnan(r[k])]
            return float(np.mean(vals)) if vals else float("nan")
        print(
            f"{b} m/s (n={len(rs)}): slot_cov {agg('slot_cov'):.2f} "
            f"gate_open {agg('gate_open'):.2f} AccS {agg('acc_s'):.2f} "
            f"err {agg('err_mean'):.3f} pooled_bias {agg('pooled_bias'):.3f} "
            f"n_slots {agg('n_slots'):.1f}"
        )
    worst = sorted(rows, key=lambda r: -r["err_mean"])[:12]
    print("\nworst instances:")
    for r in worst:
        print(
            f"  {r['scene']} i{r['frame']} inst{r['inst']} {r['speed']:.0f} m/s "
            f"cov {r['slot_cov']:.2f} gate {r['gate_open']:.2f} "
            f"AccS {r['acc_s']:.2f} err {r['err_mean']:.2f} "
            f"bias {r['pooled_bias']:.2f} slots {r['n_slots']}"
        )


if __name__ == "__main__":
    main()
