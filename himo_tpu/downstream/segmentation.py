"""Downstream semantic segmentation on (compensated) point clouds.

The reference's downstream seg story (downstream/README.md:29-52) runs
WaffleIron ``eval_h5.py`` over raw vs HiMo-compensated clouds and writes
per-point label keys ``seg_{flow_mode}`` into the .h5 scenes, which
``eval_seg`` then scores. This module provides the JAX equivalent:

- :class:`SegNet` — a pillar-UNet point classifier (shares the flow models'
  encoder/backbone design; per-point head over gathered pillar features);
- :func:`segment_dataset` — the ``eval_h5`` surface: optionally de-skews
  each cloud with a stored flow field first (``flow_mode``), runs the
  network, writes ``seg_valid`` and ``seg_{flow_mode}`` keys back;
- :func:`train_segmentation` — supervised training against the GT
  ``flow_category_indices`` (for producing checkpoints on labeled data).

The HiMo hypothesis this pipeline measures: de-skewing fast objects before
segmentation improves IoU (reference numbers: downstream/README.md:55-59).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from himo_tpu.models.feedforward import point_feature_net, unet
from himo_tpu.models.layers import Module, Params, dense, relu
from himo_tpu.ops.voxelize import PillarConfig, gather_pillars, scatter_max, voxelize_pillars


@dataclasses.dataclass(frozen=True)
class SegConfig:
    pillar: PillarConfig = PillarConfig()
    num_classes: int = 3  # {ignore, car, other_vehicle}
    point_feat_dim: int = 32
    base_channels: int = 32
    depths: tuple = (64, 128, 256)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SegNet(Module):
    """Pillar-UNet per-point classifier."""

    config: SegConfig

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
        out_img = unet(p["UNet_0"], image, cfg.depths, cfg.base_channels * 2, dtype)
        pillar_feat = gather_pillars(out_img, grid).astype(dtype)
        x = jnp.concatenate([pillar_feat, feat], axis=-1)
        x = relu(dense(p["Dense_0"], x, cfg.base_channels * 2, dtype))
        return dense(p["Dense_1"], x, cfg.num_classes, jnp.float32)


def make_seg_model(**overrides):
    config = SegConfig(**overrides)
    return SegNet(config), config


def init_seg_params(model: SegNet, key, num_points: int = 1024):
    return model.init(
        key, jnp.zeros((num_points, 3)), jnp.ones((num_points,), bool)
    )


def train_segmentation(
    data_dir: str,
    model: Optional[SegNet] = None,
    num_points: int = 32768,
    epochs: int = 5,
    lr: float = 1e-3,
    seed: int = 0,
    verbose: bool = True,
    deskew_gt: bool = False,
    **model_overrides,
):
    """Supervised 3-class training against GT categories; returns params.

    ``deskew_gt=True`` trains on GT-COMPENSATED (undistorted) clouds — the
    WaffleIron role: the reference's net is trained on undistorted data, so
    method-compensated inputs match its distribution while raw skewed ones
    do not (the raw-vs-compensated gap the downstream tables measure)."""
    import optax
    from tqdm import tqdm

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.eval.seg import remap_to_three_classes

    if model is None:
        model, _ = make_seg_model(**model_overrides)
    dataset = SceneFlowDataset(data_dir)
    params = init_seg_params(model, jax.random.PRNGKey(seed), num_points)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, pts, valid, labels):
        def loss_fn(p):
            logits = model.apply(p, pts, valid)
            raw = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            # Class-balanced weighting: vehicle points are rare.
            w = jnp.where(labels > 0, 10.0, 1.0) * valid
            return jnp.sum(raw * w) / jnp.maximum(jnp.sum(w), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    def fit(arr, fill=0):
        out = np.full((num_points,) + arr.shape[1:], fill, dtype=arr.dtype)
        n = min(len(arr), num_points)
        out[:n] = arr[:n]
        return out, n

    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = rng.permutation(len(dataset))
        losses = []
        for i in order:
            data = dataset[int(i)]
            if "flow_category_indices" not in data:
                continue
            xyz = data["pc0"][:, :3].astype(np.float32)
            if deskew_gt and "flow" in data:
                from himo_tpu.downstream.segmentation import _dataset_name
                from himo_tpu.eval.pipeline import prepare_frame

                frame = prepare_frame(data, _dataset_name(data_dir), res_name=None)
                xyz = xyz + (frame["gt_flow"] / 0.1) * frame["dt0"][:, None]
            pts, n = fit(xyz)
            valid = np.zeros(num_points, bool)
            valid[:n] = True
            labels, _ = fit(
                remap_to_three_classes(data["flow_category_indices"]).astype(np.int32)
            )
            params, opt_state, loss = step(params, opt_state, pts, valid, labels)
            losses.append(float(loss))
        if verbose:
            print(f"[seg] epoch {epoch}: loss {np.mean(losses):.4f}")
    return params


def segment_dataset(
    data_dir: str,
    model: SegNet,
    params,
    flow_mode: str = "raw",
    num_points: int = 32768,
    sensor_dt: float = 0.1,
    verbose: bool = True,
) -> int:
    """Run segmentation over every frame, de-skewing with ``flow_mode`` first.

    Writes ``seg_{flow_mode}`` (predicted AV2-bucket class per point, encoded
    as 3-class ids) and ``seg_valid`` into each frame group — the WaffleIron
    ``eval_h5.py`` write-back contract (consumed at
    downstream/eval_seg.py:219-223).
    """
    import h5py
    from tqdm import tqdm

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.eval.pipeline import prepare_frame

    dataset = SceneFlowDataset(
        data_dir, vis_name=flow_mode if flow_mode != "raw" else ""
    )

    @jax.jit
    def infer(pts, valid):
        return jnp.argmax(model.apply(params, pts, valid), axis=-1)

    it = range(len(dataset))
    if verbose:
        it = tqdm(it, ncols=100, desc=f"Segmenting ({flow_mode}) {data_dir}")
    written = 0
    for i in it:
        data = dataset[i]
        # ``gt`` de-skews with the GT motion flow (the on-distribution upper
        # bound for deskew_gt-trained nets); frames without the stored flow
        # key (each scene's last sweep has no successor) fall back to raw.
        res = flow_mode
        if flow_mode == "gt" or (flow_mode != "raw" and flow_mode not in data):
            res = None
        frame = prepare_frame(data, _dataset_name(data_dir), res_name=res)
        pts = frame["xyz"]
        motion = None
        if flow_mode == "gt":
            motion = frame["gt_flow"]
        elif res is not None and flow_mode != "raw":
            motion = frame["est_flow"]
        if motion is not None:
            # De-skew before segmenting — the HiMo downstream hypothesis.
            comp = (motion / sensor_dt) * frame["dt0"][:, None]
            pts = pts + comp
        n = len(pts)
        padded = np.zeros((num_points, 3), np.float32)
        padded[: min(n, num_points)] = pts[:num_points]
        valid = np.zeros(num_points, bool)
        valid[: min(n, num_points)] = True
        pred = np.asarray(infer(padded, valid))[:n]
        if n > num_points:
            pred = np.concatenate([pred, np.zeros(n - num_points, pred.dtype)])

        with h5py.File(dataset.directory / f"{data['scene_id']}.h5", "a") as f:
            g = f[str(data["timestamp"])]
            for key, arr in (
                (f"seg_{flow_mode}", _expand_labels(pred)),
                ("seg_valid", np.ones(n, np.uint8)),
            ):
                if key in g:
                    del g[key]
                g.create_dataset(key, data=arr)
        written += 1
    return written


def _expand_labels(three_class: np.ndarray) -> np.ndarray:
    """3-class ids -> representative AV2 category indices so eval_seg's
    remap recovers them (1 -> REGULAR_VEHICLE, 2 -> TRUCK)."""
    from himo_tpu.core.categories import CATEGORY_TO_INDEX

    out = np.zeros(len(three_class), dtype=np.uint8)
    out[three_class == 1] = CATEGORY_TO_INDEX["REGULAR_VEHICLE"]
    out[three_class == 2] = CATEGORY_TO_INDEX["TRUCK"]
    return out


def _dataset_name(data_dir: str) -> str:
    from himo_tpu.core.dataset_id import infer_dataset_name

    try:
        return infer_dataset_name(str(data_dir))
    except ValueError:
        return "av2"
