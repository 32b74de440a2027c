"""Per-instance MPE / Chamfer evaluation with velocity & distance bucketing.

Behaviorally equivalent to the reference's ``InstanceMetrics``
(/root/reference/eval.py:24-268), including its aggregation quirks which the
leaderboard scorer documents as canonical (tools/test/score.py:203-208):

- instances with < 10 points or velocity < min_vel are skipped
  (min_vel = 1.5 m/s for Scania, 3.0 otherwise — eval.py:30-36);
- per frame, instances bucket by velocity AND ego distance
  (0-10 / 10-20 / 20-30 / 30+); a value of exactly 0 falls in no bucket;
- per-frame category summary: point-count-weighted mean within each VELOCITY
  bucket, then an unweighted nanmean across buckets (eval.py:129-141) —
  distance buckets contribute to breakdowns only;
- across frames: category mean = per-frame means weighted by per-frame point
  counts; the reported std is the std of per-frame stds (eval.py:218-221);
- the "# Objs" column counts frames-with-instances, not instances.

One DELIBERATE deviation: the reference buckets instance ego-distance with a
norm over ALL pc columns — including intensity (eval.py:94,
``pc[mask_class][mask]`` is (N, 4)) — so a bright distant point inflates the
"distance". This implementation uses xyz only by default;
``strict_parity=True`` (CLI ``strict_parity=true``) reproduces the
reference's 4-column norm bit-for-bit for leaderboard cross-checks on real
data, where intensity is nonzero and the ``distance`` breakdowns would
otherwise diverge. Pinned by tests/test_eval_pipeline.py.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from himo_tpu.core.categories import BUCKETED_METACATAGORIES, CATEGORY_TO_INDEX
from himo_tpu.eval.chamfer import chamfer_distance_host, mean_point_error


def _comp_dis_np(flow: np.ndarray, dt0: np.ndarray, sensor_dt: float) -> np.ndarray:
    """Numpy twin of core.compensation.flow_to_comp_dis — per-frame host
    loops must not dispatch per-op to the device (per-op dispatch latency dominates)."""
    return flow / sensor_dt * dt0[:, None]

RANGES = ("0-10", "10-20", "20-30", "30+")
TARGET_CATEGORIES = ("CAR", "OTHER_VEHICLES")


def _bucket(value: float) -> Optional[str]:
    if 0 < value < 10:
        return "0-10"
    if 10 <= value < 20:
        return "10-20"
    if 20 <= value < 30:
        return "20-30"
    if value >= 30:
        return "30+"
    return None


def _empty_bucket() -> Dict[str, list]:
    return {"num_pts": [], "mpe": [], "cham": [], "std_mpe": [], "std_cham": []}


def _empty_store() -> Dict[str, dict]:
    store: Dict[str, dict] = {}
    for cat in TARGET_CATEGORIES:
        store[cat] = {
            "vel": {r: _empty_bucket() for r in RANGES},
            "dis": {r: _empty_bucket() for r in RANGES},
            "mean": _empty_bucket(),
        }
    return store


def _safe_average(values, weights) -> float:
    if len(values) > 0 and np.sum(weights) > 0:
        return float(np.average(values, weights=weights))
    return 0.0


def _safe_std(values) -> float:
    return float(np.std(values)) if len(values) > 0 else 0.0


class InstanceMetrics:
    """Accumulates compensation-quality metrics over frames."""

    def __init__(
        self,
        data_name: str,
        sensor_hz: float = 10.0,
        chamfer_fn: Callable[[np.ndarray, np.ndarray], float] = chamfer_distance_host,
        strict_parity: bool = False,
    ):
        self.data_name = data_name
        self.sensor_dt = 1.0 / sensor_hz
        # strict_parity: distance-bucket norm over ALL pc columns (incl.
        # intensity), matching the reference quirk at eval.py:94.
        self.strict_parity = strict_parity
        self.frame_cnt = 0
        # Scania pseudo-labels mislabel slow motion; 1-2 LiDAR rigs show no
        # distortion at low speed (reference eval.py:30-36).
        self.min_vel = 1.5 if data_name == "scania" else 3.0
        self.chamfer_fn = chamfer_fn
        self.data = _empty_store()

    # ---------------------------------------------------------------- step

    def step(
        self,
        pc: np.ndarray,
        gt_flow: np.ndarray,
        dt0: np.ndarray,
        category_indices: np.ndarray,
        instance_ids: np.ndarray,
        est_flow: Optional[np.ndarray] = None,
        est_dis: Optional[np.ndarray] = None,
    ) -> None:
        """Evaluate one frame. Exactly one of est_flow / est_dis is given.

        All arrays are already restricted to evaluation-eligible points.
        """
        if (est_flow is None) == (est_dis is None):
            raise ValueError("provide exactly one of est_flow or est_dis")
        if est_flow is not None:
            est_dis = _comp_dis_np(est_flow, dt0, self.sensor_dt)
        refined = pc[:, :3] + est_dis
        gt_refined = pc[:, :3] + _comp_dis_np(gt_flow, dt0, self.sensor_dt)

        frame = _empty_store()
        for cat in TARGET_CATEGORIES:
            class_ids = np.array(
                [CATEGORY_TO_INDEX[c] for c in BUCKETED_METACATAGORIES[cat]]
            )
            cls_mask = np.isin(category_indices, class_ids)
            if not np.any(cls_mask):
                continue
            inst_cls = instance_ids[cls_mask]
            gt_flow_cls = gt_flow[cls_mask]
            refined_cls = refined[cls_mask]
            gt_refined_cls = gt_refined[cls_mask]
            pc_cls = pc[cls_mask]

            for inst in np.unique(inst_cls):
                m = inst_cls == inst
                num_pts = int(np.sum(m))
                vel = float(
                    np.linalg.norm(gt_flow_cls[m], axis=1).mean() / self.sensor_dt
                )
                if num_pts < 10 or vel < self.min_vel:
                    continue
                dis_cols = pc_cls[m] if self.strict_parity else pc_cls[m][:, :3]
                dis = float(np.linalg.norm(dis_cols, axis=1).mean())
                mpe = mean_point_error(gt_refined_cls[m], refined_cls[m])
                cham = self.chamfer_fn(gt_refined_cls[m], refined_cls[m])
                for metric, value in (("vel", vel), ("dis", dis)):
                    rng = _bucket(value)
                    if rng is None:
                        print(
                            f"--- [ERROR]: no bucket for value {value} in {metric} ---"
                        )
                        continue
                    slot = frame[cat][metric][rng]
                    slot["num_pts"].append(num_pts)
                    slot["mpe"].append(mpe)
                    slot["cham"].append(cham)

        # ---- fold the frame into the global store --------------------------
        for cat in frame:
            frame_totals, frame_mpes, frame_chams = [], [], []
            for metric in ("vel", "dis"):
                for rng in RANGES:
                    slot = frame[cat][metric][rng]
                    if not slot["num_pts"]:
                        continue
                    weights = slot["num_pts"]
                    g = self.data[cat][metric][rng]
                    g["num_pts"] += weights
                    g["mpe"] += slot["mpe"]
                    g["cham"] += slot["cham"]
                    if metric == "vel":  # only the velocity view feeds the mean
                        frame_mpes.append(float(np.average(slot["mpe"], weights=weights)))
                        frame_chams.append(
                            float(np.average(slot["cham"], weights=weights))
                        )
                        frame_totals.append(int(np.sum(weights)))
            if sum(frame_totals) == 0:
                continue
            mean = self.data[cat]["mean"]
            mean["num_pts"].append(int(sum(frame_totals)))
            mean["mpe"].append(float(np.nanmean(frame_mpes)))
            mean["cham"].append(float(np.nanmean(frame_chams)))
            mean["std_mpe"].append(float(np.nanstd(frame_mpes)))
            mean["std_cham"].append(float(np.nanstd(frame_chams)))

        self.frame_cnt += 1

    # kept as an alias for reference-familiar call sites (eval.py:64)
    step_eval = step

    # ------------------------------------------------------------- summarize

    def category_summary(self, cat: str) -> Optional[dict]:
        mean = self.data[cat]["mean"]
        if not mean["num_pts"]:
            return None
        summary = {
            "mpe": _safe_average(mean["mpe"], mean["num_pts"]),
            "cd": _safe_average(mean["cham"], mean["num_pts"]),
            "std_mpe": _safe_std(mean["std_mpe"]),
            "std_cd": _safe_std(mean["std_cham"]),
            "num_pts": int(np.sum(mean["num_pts"])),
            "num_obj": len(mean["num_pts"]),
            "velocity": {},
            "distance": {},
        }
        for metric, key in (("vel", "velocity"), ("dis", "distance")):
            for rng in RANGES:
                slot = self.data[cat][metric][rng]
                summary[key][rng] = {
                    "mpe": _safe_average(slot["mpe"], slot["num_pts"]),
                    "cd": _safe_average(slot["cham"], slot["num_pts"]),
                    "num_pts": int(np.sum(slot["num_pts"])) if slot["num_pts"] else 0,
                    "num_obj": len(slot["num_pts"]),
                }
        return summary

    def total_summary(self) -> Optional[dict]:
        mpes, chams, weights = [], [], []
        for cat in TARGET_CATEGORIES:
            mean = self.data[cat]["mean"]
            mpes += mean["mpe"]
            chams += mean["cham"]
            weights += mean["num_pts"]
        if not weights:
            return None
        return {
            "mpe": _safe_average(mpes, weights),
            "cd": _safe_average(chams, weights),
            "num_pts": int(np.sum(weights)),
            "num_obj": len(weights),
        }

    # ----------------------------------------------------------------- print

    def print(self, res_name: str = "flow", file_name: str = "result_av2.json") -> None:
        """Print the fancy_grid summary table and append detailed JSON."""
        from tabulate import tabulate

        display = {"CAR": "CAR", "OTHER_VEHICLES": "OTHERS"}
        rows: List[list] = []
        print(f"\nHiMo refinement metrics for {res_name} in {self.data_name}:")
        for cat in TARGET_CATEGORIES:
            s = self.category_summary(cat)
            if s is None:
                continue
            self._save_json(file_name, res_name, cat, s)
            rows.append(
                [
                    display[cat],
                    f"{s['cd']:.3f} ± {s['std_cd']:.2f}",
                    f"{s['mpe']:.3f} ± {s['std_mpe']:.2f}",
                    s["num_pts"],
                    s["num_obj"],
                ]
            )
        total = self.total_summary()
        if total is not None:
            rows.insert(
                0,
                [
                    "Total",
                    f"{total['cd']:.3f}",
                    f"{total['mpe']:.3f}",
                    total["num_pts"],
                    total["num_obj"],
                ],
            )
        headers = ["Class", "CDE (Chamfer) ↓", "MPE (Point Err) ↓", "# Points", "# Objs"]
        print(tabulate(rows, headers=headers, tablefmt="fancy_grid", stralign="center"))
        print(f"Total frames processed: {self.frame_cnt}")
        print(f"Results saved to {file_name}\n")

    def _save_json(self, file_name: str, res_name: str, cat: str, summary: dict) -> None:
        data = {}
        if os.path.exists(file_name):
            try:
                with open(file_name) as f:
                    data = json.load(f)
            except json.JSONDecodeError:
                data = {}
        entry = {
            "overall": {
                "mpe": summary["mpe"],
                "cd": summary["cd"],
                "std_mpe": summary["std_mpe"],
                "std_cd": summary["std_cd"],
                "num_pts": summary["num_pts"],
                "num_obj": summary["num_obj"],
            },
            "velocity": summary["velocity"],
            "distance": summary["distance"],
        }
        data.setdefault(self.data_name, {}).setdefault(res_name, {})[cat] = entry
        with open(file_name, "w") as f:
            json.dump(data, f, indent=4)
