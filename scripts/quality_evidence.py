"""Quality-parity evidence at scale: cross-method table on the bucket-
complete synthetic validation suite.

Reproduces (synthetically) the reference's README quality table protocol
(/root/reference/README.md:95: CDE/MPE on a labeled val split) across every
estimator family, plus the scene-flow-challenge EPE/Acc numbers:

    python scripts/quality_evidence.py \
        [--root /tmp/av2_quality] [--skip-train]

Reproducibility (round-3 verdict: icpflow moved ±0.05 between reruns with
the cause untracked): ``--seeds 0,1,2`` builds one dataset per seed, runs
the full pipeline on each, and prints mean±spread cells — round-over-round
deltas are falsifiable against the measured spread instead of hand-waved.

Density (round-3 verdict: all quality evidence sat at ~18.4k pts/frame,
3.5× below the bench's own 65k): ``--bg-points 57000 --obj-points 1400``
regenerates the suite at production density (57k background + 6×1400 object
points ≈ 65.4k/frame, matching bench.py's 65,536-point clouds).

Outputs: res-av2.json + res-flow-av2.json entries per method and a markdown
table on stdout (pasted into PARITY.md).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

METHODS_OPT = ("nsfp", "fastnsf10", "icpflow")


def run_one(args, root: Path, seed: int) -> dict:
    """Full pipeline on one dataset seed; returns {method: {metric: value}}."""
    from himo_tpu.data.synthetic import make_benchmark_dataset

    if not root.exists():
        print(f"[1/5] building benchmark dataset at {root} (seed {seed}, "
              f"{args.bg_points} bg + 6x{args.obj_points} obj pts)")
        make_benchmark_dataset(
            root,
            seed=seed,
            num_background=args.bg_points,
            points_per_object=args.obj_points,
        )
    else:
        print(f"[1/5] reusing dataset at {root}")

    from himo_tpu.training.ssl_labels import write_ssl_labels_dufo

    t0 = time.time()
    methods = []
    if not args.skip_train:
        print("[2/5] DUFO SSL labels + SeFlow++ SSL training")
        if not args.skip_labels:
            write_ssl_labels_dufo(root, verbose=True)
        from himo_tpu.training.trainer import TrainConfig, train

        train_models = [args.model]
        if args.ablate_noprior and args.model == "seflowpp":
            # Point-wise-decoder ablation row: same recipe, no instance
            # head (its delta against the flagship is the in-net
            # per-object pooling's contribution).
            train_models.append("seflowpp_noprior")
        if args.trust and args.model == "seflowpp":
            # Offline/labeling hybrid row (round 4's flagship): prior-
            # conditioned + verbatim trust. Evaluated with CAUSAL fresh
            # priors (prior_source='fresh') — the on-disk ssl_prior carries
            # the non-causal scene-start backcast repair, which would
            # flatter the row (ADVICE round 4).
            train_models.append("seflowpp_trust")
        for tm in train_models:
            config = TrainConfig(
                model=tm,
                batch_size=8,
                epochs=args.epochs,
                lr=args.lr,
                step_lr_epochs=args.lr_step,
                num_points=args.num_points,
                loss_points=8192,
                log_every=10,
                val_every=3,
                seed=seed,
            )
            result = train(
                str(root), config, run_dir=str(root / f"runs/{tm}")
            )
            params = result["params"]
            print(f"  {tm} trained in {time.time() - t0:.0f}s; "
                  "writing flow (fleet)")
            from himo_tpu.parallel.fleet import FleetConfig, fleet_save

            fleet_save(
                str(root),
                model=tm,
                params=params,
                output_key=tm,
                config=FleetConfig(
                    num_points=args.num_points,
                    # Trust row: causal per-pair priors, not the label
                    # writer's non-causal backcast-repaired ones.
                    prior_source="fresh" if tm == "seflowpp_trust" else "auto",
                ),
            )
            methods.append(tm)

    if not args.skip_opt:
        from himo_tpu.models.runner import estimate_scene_flow

        for m in METHODS_OPT:
            print(f"[3/5] optimization method {m}")
            t1 = time.time()
            estimate_scene_flow(
                str(root),
                model=m,
                max_estimation_points=args.max_est_points or None,
            )
            print(f"  {m}: {time.time() - t1:.0f}s")
            methods.append(m)

    print("[4/5] HiMo CDE/MPE eval (full + adversarial tranche)")
    from himo_tpu.cli.eval import main as eval_main

    all_methods = ["raw"] + methods
    for m in all_methods:
        eval_main(data_dir=str(root), res_name=m)
        eval_main(data_dir=str(root), res_name=m, scene_filter="scene_adv")

    print("[5/5] EPE/Acc flow metrics (full + adversarial tranche)")
    from himo_tpu.cli.eval_flow import main as eval_flow_main

    flow_res = eval_flow_main(data_dir=str(root), res_names=all_methods)
    flow_res_adv = eval_flow_main(
        data_dir=str(root), res_names=all_methods, scene_filter="scene_adv"
    )

    def rows(himo_json: str, flow: dict, tag: str) -> dict:
        himo_res = json.loads(Path(himo_json).read_text())["av2"]
        out = {}
        for m in all_methods:
            he = himo_res.get(m, {})
            cde = mpe = float("nan")
            if he:
                cats = [
                    he[c]["overall"] for c in ("CAR", "OTHER_VEHICLES") if c in he
                ]
                pts = sum(c["num_pts"] for c in cats)
                cde = sum(c["cd"] * c["num_pts"] for c in cats) / max(pts, 1)
                mpe = sum(c["mpe"] * c["num_pts"] for c in cats) / max(pts, 1)
            fe = flow.get(m, {})
            out[m + tag] = {
                "CDE": cde,
                "MPE": mpe,
                "EPE_3way": fe.get("EPE_3way", float("nan")),
                "EPE_FD": fe.get("EPE_FD", float("nan")),
                "EPE_BS": fe.get("EPE_BS", float("nan")),
                "AccS": fe.get("AccS", float("nan")),
                "AccR": fe.get("AccR", float("nan")),
            }
        return out

    table = rows("res-av2.json", flow_res, "")
    table.update(rows("res-av2-scene_adv.json", flow_res_adv, " [adv]"))
    return table


COLS = ("CDE", "MPE", "EPE_3way", "EPE_FD", "EPE_BS", "AccS", "AccR")
ARROWS = {"AccS": "↑", "AccR": "↑"}


def print_table(tables: list) -> None:
    """Markdown table; multi-seed runs print mean±(max-min)/2 cells."""
    methods = list(tables[0].keys())
    hdr = " | ".join(f"{c} {ARROWS.get(c, '↓')}" for c in COLS)
    print(f"\n| Method | {hdr} |")
    print("|" + "---|" * (len(COLS) + 1))
    for m in methods:
        cells = []
        for c in COLS:
            vals = np.array([t[m][c] for t in tables if m in t], float)
            if len(vals) > 1:
                spread = (np.nanmax(vals) - np.nanmin(vals)) / 2
                cells.append(f"{np.nanmean(vals):.3f}±{spread:.3f}")
            else:
                cells.append(f"{vals[0]:.3f}")
        print(f"| {m} | " + " | ".join(cells) + " |")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/av2_quality")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument(
        "--ablate-noprior", action="store_true",
        help="also train/report the seflowpp_noprior (no instance head) "
        "ablation row",
    )
    ap.add_argument(
        "--trust", action="store_true",
        help="also train/report the seflowpp_trust offline hybrid row "
        "(causal fresh priors at eval)",
    )
    ap.add_argument("--skip-opt", action="store_true")
    ap.add_argument(
        "--skip-labels", action="store_true",
        help="reuse existing ssl_* keys (labels are host-side and can be "
        "pre-generated on CPU while the chip is busy/unreachable)",
    )
    ap.add_argument("--model", default="seflowpp",
                    help="feed-forward flagship to SSL-train")
    ap.add_argument("--epochs", type=int, default=12)
    # Reference recipe (lr 6e-5, StepLR(3, 0.5)) freezes lr to ~1e-9 by
    # epoch 45 — fine for the 12-epoch parity run, wasteful for long
    # headline runs. Pass e.g. --lr 1.2e-4 --lr-step 30 for those.
    ap.add_argument("--lr", type=float, default=6e-5)
    ap.add_argument("--lr-step", type=int, default=3)
    ap.add_argument("--num-points", type=int, default=20480)
    ap.add_argument("--bg-points", type=int, default=16000)
    ap.add_argument("--obj-points", type=int, default=400)
    ap.add_argument(
        "--seeds", default="0",
        help="comma-separated dataset/train seeds; >1 builds one dataset "
        "per seed (root suffixed _s{seed}) and prints mean±spread cells",
    )
    # 0 = full-resolution estimation (default): subsampling before the host
    # labeling step breaks the density-adaptive dynamic threshold's value
    # and starves object clusters (measured round 3: nsfp EPE_BS 0.34 from
    # subsample noise alone; full-res 0.013).
    ap.add_argument("--max-est-points", type=int, default=0)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]

    tables = []
    for seed in seeds:
        root = Path(args.root if len(seeds) == 1 else f"{args.root}_s{seed}")
        print(f"\n=== seed {seed} (root {root}) ===")
        tables.append(run_one(args, root, seed))
        if len(seeds) > 1:
            print_table([tables[-1]])
    print_table(tables)
    # Persist the seeded evidence (res-av2.json only keeps the LAST seed):
    # per-seed tables so round-over-round deltas stay falsifiable against
    # the measured spread (round-4 verdict #5).
    Path("res-seeded.json").write_text(
        json.dumps({"seeds": seeds, "tables": tables}, indent=1)
    )


if __name__ == "__main__":
    main()
