"""Learned 3-D detection head — CenterPoint-style on the pillar image.

The reference's detection downstream runs OpenPCDet TransFusion-L over raw
vs HiMo-compensated clouds (/root/reference/downstream/README.md:8-18).
This is the learned equivalent (upgrading the geometric
cluster-fit harness in :mod:`himo_tpu.downstream.detection`):

- pillar encoder + UNet backbone shared with the flow models;
- a center heatmap head (penalty-reduced focal loss on gaussian-splatted
  GT centers, CenterNet-style) + per-pillar box regression head
  (sub-voxel offset, z0, log-extent, sin/cos yaw);
- jittable top-K peak decoding (3x3 max-pool NMS, static K).

Experimental contract matches the reference tables: train on undistorted
(GT-compensated) clouds, detect on raw vs method-compensated ones, score
with rotated BEV IoU — compensation should recover detection quality on
fast objects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from himo_tpu.models.feedforward import point_feature_net, unet
from himo_tpu.models.layers import Module, Params, conv, relu
from himo_tpu.ops.voxelize import (
    PillarConfig,
    scatter_max,
    voxelize_pillars,
)


@dataclasses.dataclass(frozen=True)
class DetNetConfig:
    pillar: PillarConfig = PillarConfig(
        x_range=(-51.2, 51.2), y_range=(-51.2, 51.2), voxel_size=(0.4, 0.4)
    )
    point_feat_dim: int = 32
    base_channels: int = 32
    depths: Tuple[int, ...] = (64, 128)
    max_detections: int = 32
    score_threshold: float = 0.3
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class DetNet(Module):
    """Pillar-UNet center-point detector: heatmap + box regression maps."""

    config: DetNetConfig

    def __call__(self, p: Params, points, valid):
        cfg = self.config
        dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
        grid = voxelize_pillars(points, valid, cfg.pillar)
        feat = point_feature_net(
            p["PointFeatureNet_0"], points, grid.centers_offset,
            cfg.point_feat_dim, dtype,
        )
        feat = jnp.where(grid.in_range[:, None], feat, 0.0)
        image = scatter_max(feat, grid).astype(dtype)
        x = unet(p["UNet_0"], image, cfg.depths, cfg.base_channels * 2, dtype)
        x = relu(conv(p["Conv_0"], x, cfg.base_channels, dtype=dtype))
        heat = conv(p["Conv_1"], x, 1, (1, 1), dtype=jnp.float32,
                    bias_init=jax.nn.initializers.constant(-2.19))[..., 0]
        reg = conv(p["Conv_2"], x, 8, (1, 1), dtype=jnp.float32)
        return heat, reg  # (H, W), (H, W, 8)


def make_det_model(**overrides):
    config = DetNetConfig(**overrides)
    return DetNet(config), config


def init_det_params(model: DetNet, key, num_points: int = 1024):
    return model.init(
        key, jnp.zeros((num_points, 3)), jnp.ones((num_points,), bool)
    )


# ------------------------------------------------------------------ targets


def _gaussian_radius(l_pix: float, w_pix: float, min_overlap: float = 0.5) -> int:
    """CenterNet-style radius so a center shifted by r still overlaps."""
    r = 0.5 * min(l_pix, w_pix) * (1.0 - min_overlap) / (1.0 + min_overlap) + 1.0
    return max(int(r), 1)


def render_targets(
    boxes: List[np.ndarray], config: DetNetConfig
) -> Dict[str, np.ndarray]:
    """GT boxes (x, y, z0, l, w, h, yaw) -> heatmap + regression targets."""
    h, w = config.pillar.grid_shape
    vx, vy = config.pillar.voxel_size
    x0, y0 = config.pillar.x_range[0], config.pillar.y_range[0]
    heat = np.zeros((h, w), np.float32)
    reg = np.zeros((h, w, 8), np.float32)
    mask = np.zeros((h, w), bool)
    for box in boxes:
        x, y, z0, l, wd, hh, yaw = [float(v) for v in box[:7]]
        fx = (x - x0) / vx
        fy = (y - y0) / vy
        ix, iy = int(np.floor(fx)), int(np.floor(fy))
        if not (0 <= ix < w and 0 <= iy < h):
            continue
        radius = _gaussian_radius(max(l / vx, 1.0), max(wd / vy, 1.0))
        ys, xs = np.ogrid[-radius : radius + 1, -radius : radius + 1]
        gauss = np.exp(-(xs * xs + ys * ys) / (2 * (radius / 3 + 1e-6) ** 2))
        t, b = max(iy - radius, 0), min(iy + radius + 1, h)
        lft, r = max(ix - radius, 0), min(ix + radius + 1, w)
        heat[t:b, lft:r] = np.maximum(
            heat[t:b, lft:r],
            gauss[
                t - iy + radius : b - iy + radius,
                lft - ix + radius : r - ix + radius,
            ],
        )
        heat[iy, ix] = 1.0
        reg[iy, ix] = [
            fx - ix - 0.5,
            fy - iy - 0.5,
            z0,
            np.log(max(l, 0.1)),
            np.log(max(wd, 0.1)),
            np.log(max(hh, 0.1)),
            np.sin(yaw),
            np.cos(yaw),
        ]
        mask[iy, ix] = True
    return {"heat": heat, "reg": reg, "mask": mask}


# -------------------------------------------------------------------- loss


def detection_loss(heat_logits, reg_pred, targets, reg_weight: float = 1.0):
    """Penalty-reduced focal loss (CenterNet) + masked L1 regression."""
    heat_t = targets["heat"]
    p = jax.nn.sigmoid(heat_logits)
    pos = heat_t >= 0.999
    eps = 1e-6
    pos_loss = -jnp.where(pos, ((1 - p) ** 2) * jnp.log(p + eps), 0.0)
    neg_loss = -jnp.where(
        ~pos, ((1 - heat_t) ** 4) * (p ** 2) * jnp.log(1 - p + eps), 0.0
    )
    n_pos = jnp.maximum(jnp.sum(pos.astype(jnp.float32)), 1.0)
    focal = (jnp.sum(pos_loss) + jnp.sum(neg_loss)) / n_pos
    mask = targets["mask"][..., None]
    l1 = jnp.sum(jnp.abs(reg_pred - targets["reg"]) * mask) / jnp.maximum(
        jnp.sum(mask) * 8.0, 1.0
    )
    return focal + reg_weight * l1, {"focal": focal, "reg_l1": l1}


# ------------------------------------------------------------------- decode


def decode_boxes(heat_logits, reg, config: DetNetConfig):
    """Top-K peak decoding: (K, 7) boxes + (K,) scores (jittable)."""
    h, w = config.pillar.grid_shape
    vx, vy = config.pillar.voxel_size
    x0, y0 = config.pillar.x_range[0], config.pillar.y_range[0]
    heat = jax.nn.sigmoid(heat_logits)
    hmax = jax.lax.reduce_window(
        heat, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    peaks = jnp.where(heat >= hmax, heat, 0.0)
    scores, idx = jax.lax.top_k(peaks.reshape(-1), config.max_detections)
    iy = idx // w
    ix = idx % w
    r = reg.reshape(h * w, 8)[idx]
    cx = x0 + (ix.astype(jnp.float32) + 0.5 + r[:, 0]) * vx
    cy = y0 + (iy.astype(jnp.float32) + 0.5 + r[:, 1]) * vy
    yaw = jnp.arctan2(r[:, 6], r[:, 7])
    boxes = jnp.stack(
        [cx, cy, r[:, 2], jnp.exp(r[:, 3]), jnp.exp(r[:, 4]), jnp.exp(r[:, 5]), yaw],
        axis=1,
    )
    return boxes, scores


# ----------------------------------------------------------------- training


def train_detector(
    data_dir: str,
    model: Optional[DetNet] = None,
    num_points: int = 32768,
    epochs: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    min_points: int = 15,
    verbose: bool = True,
    **model_overrides,
):
    """Train on GT-COMPENSATED clouds with boxes fitted to GT instances
    (labels-as-boxes, as the geometric harness's GT). Returns params."""
    import optax

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.downstream.detection import gt_boxes_from_instances
    from himo_tpu.downstream.segmentation import _dataset_name
    from himo_tpu.eval.pipeline import prepare_frame

    if model is None:
        model, config = make_det_model(**model_overrides)
    else:
        config = model.config
    dataset = SceneFlowDataset(data_dir, eval=True)
    params = init_det_params(model, jax.random.PRNGKey(seed), num_points)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, pts, valid, heat, reg, mask):
        def loss_fn(p):
            hl, rp = model.apply(p, pts, valid)
            loss, aux = detection_loss(
                hl, rp, {"heat": heat, "reg": reg, "mask": mask}
            )
            return loss, aux

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    def fit(arr):
        out = np.zeros((num_points,) + arr.shape[1:], arr.dtype)
        n = min(len(arr), num_points)
        out[:n] = arr[:n]
        return out, n

    name = _dataset_name(data_dir)
    frames = []
    for i in range(len(dataset)):
        data = dataset[i]
        frame = prepare_frame(data, name, res_name=None)
        gt_comp = (frame["gt_flow"] / 0.1) * frame["dt0"][:, None]
        pts = frame["xyz"] + gt_comp
        inst = np.asarray(data["flow_instance_id"])
        gm = np.asarray(data["gm0"], bool)
        focus = (inst > 0) & ~gm
        boxes = gt_boxes_from_instances(pts[focus], inst[focus], min_points)
        if not boxes:
            continue
        targets = render_targets(boxes, config)
        pts_p, n = fit(pts[focus].astype(np.float32))
        valid = np.zeros(num_points, bool)
        valid[: min(int(focus.sum()), num_points)] = True
        frames.append((pts_p, valid, targets))

    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        losses = []
        for i in rng.permutation(len(frames)):
            pts_p, valid, targets = frames[int(i)]
            params, opt_state, loss = step(
                params,
                opt_state,
                jnp.asarray(pts_p),
                jnp.asarray(valid),
                jnp.asarray(targets["heat"]),
                jnp.asarray(targets["reg"]),
                jnp.asarray(targets["mask"]),
            )
            losses.append(float(loss))
        if verbose:
            print(f"[det] epoch {epoch}: loss {np.mean(losses):.4f}")
    return params


# --------------------------------------------------------------- evaluation


def make_infer(model: DetNet, params):
    """One jitted decode closure reused across frames (avoids re-tracing)."""
    config = model.config

    @jax.jit
    def infer(pts, valid):
        hl, rp = model.apply(params, pts, valid)
        return decode_boxes(hl, rp, config)

    return infer


def detect_frame_learned(
    model: DetNet,
    params,
    points: np.ndarray,
    num_points: int = 32768,
    infer=None,
) -> List[np.ndarray]:
    """Boxes above the score threshold for one (focus-filtered) cloud."""
    config = model.config
    if infer is None:
        infer = make_infer(model, params)
    pts = np.zeros((num_points, 3), np.float32)
    n = min(len(points), num_points)
    pts[:n] = points[:n, :3]
    valid = np.zeros(num_points, bool)
    valid[:n] = True
    boxes, scores = infer(jnp.asarray(pts), jnp.asarray(valid))
    boxes, scores = np.asarray(boxes), np.asarray(scores)
    keep = scores >= config.score_threshold
    return [boxes[i] for i in np.flatnonzero(keep)]


def evaluate_detection_learned(
    data_dir: str,
    model: DetNet,
    params,
    flow_mode: str = "raw",
    num_points: int = 32768,
    iou_threshold: float = 0.3,
    min_points: int = 15,
    dynamic_only: bool = True,
    verbose: bool = True,
) -> Dict[str, float]:
    """The geometric harness's protocol with the learned detector: detect on
    raw or de-skewed clouds, score vs GT-compensated instance boxes."""
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.downstream.detection import gt_boxes_from_instances, match_detections
    from himo_tpu.downstream.segmentation import _dataset_name
    from himo_tpu.eval.pipeline import prepare_frame

    dataset = SceneFlowDataset(
        data_dir, vis_name=flow_mode if flow_mode != "raw" else "", eval=True
    )
    name = _dataset_name(data_dir)
    infer = make_infer(model, params)
    totals = {"tp": 0, "fp": 0, "fn": 0}
    ious = []
    for i in range(len(dataset)):
        data = dataset[i]
        # ``gt`` de-skews with the GT motion flow (upper-bound control).
        res = None if flow_mode == "gt" else flow_mode
        frame = prepare_frame(data, name, res_name=res)
        pts = frame["xyz"]
        motion = frame["gt_flow"] if flow_mode == "gt" else frame["est_flow"]
        comp = (motion / 0.1) * frame["dt0"][:, None]
        det_pts = pts + comp
        gt_comp = (frame["gt_flow"] / 0.1) * frame["dt0"][:, None]
        gt_pts = pts + gt_comp
        inst = np.asarray(data["flow_instance_id"])
        gm = np.asarray(data["gm0"], bool)
        focus = ((inst > 0) & ~gm) if dynamic_only else ~gm
        dets = detect_frame_learned(
            model, params, det_pts[focus], num_points, infer=infer
        )
        gts = gt_boxes_from_instances(gt_pts[focus], inst[focus], min_points)
        # A grid detector can only see its range: standard range-filtered
        # evaluation (GT centers outside the pillar grid are excluded).
        pil = model.config.pillar
        gts = [
            g
            for g in gts
            if pil.x_range[0] <= g[0] <= pil.x_range[1]
            and pil.y_range[0] <= g[1] <= pil.y_range[1]
        ]
        m = match_detections(dets, gts, iou_threshold)
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
            f"[learned/{flow_mode}] P {precision:.3f} R {recall:.3f} "
            f"F1 {result['f1']:.3f} meanIoU {result['mean_iou']:.3f}"
        )
    return result
