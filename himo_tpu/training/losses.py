"""Self-supervised scene-flow losses — the seflowppLoss recipe.

The reference trains SeFlow++ with ``loss_fn=seflowppLoss`` and weights
``{chamfer_dis: 1.0, static_flow_loss: 1.0, dynamic_chamfer_dis: 1.0,
cluster_based_pc0pc1: 1.0}`` (assets/slurm/ssl-train-av2.sh:33). The four
terms, re-derived for jit (all static shapes, NN via ``ops/nn.py``):

- ``chamfer_dis``     — truncated Chamfer between warped pc0 and pc1 over all
  non-ground points: the base alignment signal.
- ``static_flow_loss``— residual flow on SSL-static points is penalized to 0
  (the pose flow already explains them).
- ``dynamic_chamfer_dis`` — Chamfer restricted to SSL-dynamic points on both
  sides: sharpens moving-object alignment that the global term washes out.
- ``cluster_based_pc0pc1`` — rigidity within SSL clusters: per-cluster flow
  variance, computed with segment reductions over a static cluster-count
  bound.

SSL labels (dynamic mask + cluster ids) come from
:mod:`himo_tpu.training.ssl_labels` (the ``+ssl_label=seflowpp_auto``
surface).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp

from himo_tpu.ops.nn import fused_chamfer_terms


@dataclasses.dataclass(frozen=True)
class SSLLossWeights:
    chamfer_dis: float = 1.0
    static_flow_loss: float = 1.0
    dynamic_chamfer_dis: float = 1.0
    cluster_based_pc0pc1: float = 1.0
    # Fast-object translation prior (himo_tpu extension, see
    # training/ssl_labels.translation_priors): penalizes deviation from the
    # matched-cluster centroid delta — the only loss term whose gradient
    # reaches objects moving beyond every chamfer truncation radius.
    prior_flow_loss: float = 1.0
    # Static-vs-dynamic gate head supervision (himo_tpu extension,
    # models/feedforward.py gate_head): BCE between the decoder's gate
    # logits and the SSL dynamic mask. Active only when the model emits
    # gate logits.
    gate_loss: float = 1.0
    # Instance head's per-pillar dynamic image supervision (himo_tpu
    # extension, models/feedforward.py instance_head): class-balanced BCE
    # between the UNet's dynamic logit image and the scattered SSL
    # object-positive mask. Active only when the model emits the image.
    dyn_img_loss: float = 1.0


def _masked_mean(values: jax.Array, mask: jax.Array) -> jax.Array:
    return jnp.sum(jnp.where(mask, values, 0.0)) / jnp.maximum(
        jnp.sum(mask.astype(values.dtype)), 1.0
    )


def static_flow_loss(flow: jax.Array, static_mask: jax.Array) -> jax.Array:
    """Mean squared residual flow on SSL-static points."""
    return _masked_mean(jnp.sum(flow * flow, axis=1), static_mask)


def cluster_rigidity_loss(
    flow: jax.Array,
    cluster_ids: jax.Array,
    valid: jax.Array,
    num_clusters: int,
) -> jax.Array:
    """Within-cluster flow variance via segment reductions (0 = no cluster)."""
    in_cluster = valid & (cluster_ids > 0)
    cid = jnp.where(in_cluster, cluster_ids, 0).astype(jnp.int32)
    ones = in_cluster.astype(jnp.float32)
    counts = jax.ops.segment_sum(ones, cid, num_segments=num_clusters)
    sums = jax.ops.segment_sum(
        jnp.where(in_cluster[:, None], flow, 0.0), cid, num_segments=num_clusters
    )
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    dev = flow - means[cid]
    return _masked_mean(jnp.sum(dev * dev, axis=1), in_cluster)


def prior_flow_loss(
    flow: jax.Array,
    prior_flow: jax.Array,
    prior_valid: jax.Array,
) -> jax.Array:
    """Mean squared deviation from the cluster translation prior."""
    dev = flow - prior_flow
    return _masked_mean(jnp.sum(dev * dev, axis=1), prior_valid)


def gate_bce_loss(
    gate_logit: jax.Array,  # (N,) decoder gate logits
    dynamic: jax.Array,  # (N,) bool SSL dynamic mask (the positive class)
    valid: jax.Array,
) -> jax.Array:
    """Per-point BCE between the gate head and the SSL dynamic evidence.

    The logit form (``softplus(-x) + (1-y)*x``) keeps gradients finite at
    saturation. Points the SSL labeler missed are not lost causes: the flow
    losses differentiate THROUGH the sigmoid gate, so a chamfer/prior
    gradient can hold a gate open against a noisy negative label."""
    y = dynamic.astype(jnp.float32)
    bce = jax.nn.softplus(-gate_logit) + (1.0 - y) * gate_logit
    return _masked_mean(bce, valid)


def dyn_image_loss(
    dyn_logit: jax.Array,  # (H, W) instance-head dynamic logit image
    pc0: jax.Array,  # (N, 3) ego-compensated sweep 0
    valid0: jax.Array,
    obj_pos: jax.Array,  # (N,) bool object-positive SSL evidence
    pillar,
) -> jax.Array:
    """Class-balanced per-pillar BCE for the instance head's dynamic image.

    A pillar is positive iff any of its points carries object-positive SSL
    evidence (the paint-expanded priors complete the interior the raw
    dynamic mask misses — see seflowpp_loss). Dynamic pillars are ~1-2% of
    the grid, so the positive and negative means are balanced separately —
    a flat mean would let the background wash out the object gradient, and
    the occupancy this image drives gates every pooled instance."""
    from himo_tpu.ops.voxelize import scatter_max, voxelize_pillars

    grid = voxelize_pillars(pc0, valid0, pillar)
    img = scatter_max(obj_pos.astype(jnp.float32)[:, None], grid)[..., 0]
    y = img > 0.5
    x = dyn_logit
    bce = jax.nn.softplus(-x) + jnp.where(y, 0.0, x)
    return 0.5 * (_masked_mean(bce, y) + _masked_mean(bce, ~y))


def _assemble(weights: SSLLossWeights, terms: Dict[str, jax.Array]):
    total = sum(getattr(weights, k) * v for k, v in terms.items())
    return {"total": total, **terms}


def seflowpp_loss(
    flow: jax.Array,  # (N, 3) predicted residual flow for pc0
    pc0: jax.Array,  # (N, 3) ego-compensated sweep 0
    pc1: jax.Array,  # (M, 3) sweep 1
    valid0: jax.Array,
    valid1: jax.Array,
    dynamic0: jax.Array,  # (N,) SSL dynamic mask for pc0
    dynamic1: jax.Array,  # (M,) SSL dynamic mask for pc1
    cluster0: jax.Array,  # (N,) int32 cluster id, 0 = background/none
    num_clusters: int = 64,
    weights: SSLLossWeights = SSLLossWeights(),
    max_dist: float = 2.0,
    dynamic_max_dist: float | None = None,
    prior0: jax.Array | None = None,  # (N, 3) translation prior
    prior_valid0: jax.Array | None = None,  # (N,)
    gate_logit0: jax.Array | None = None,  # (N,) gate-head logits
) -> Dict[str, jax.Array]:
    """All SSL terms + their weighted total.

    Fast-object extensions (both optional, both zero-cost in the NN pass):
    ``dynamic_max_dist`` widens the dynamic chamfer truncation, and
    ``prior0``/``prior_valid0`` activate the cluster translation prior.
    ``gate_logit0`` activates the gate-head BCE term."""
    warped = pc0[:, :3] + flow
    # Strong labels beat weak ones: prior-covered points keep their chamfer
    # VALUE (they remain geometric evidence for both directions) but send no
    # chamfer GRADIENT — on a rolling-shutter smear the chamfer's optimum is
    # biased (any surface overlap scores well), and it measurably degraded
    # verified priors (median output err 0.175 m on covered dynamic points
    # whose raw prior err was 0.026; 120-epoch headline). prior_flow_loss is
    # the sole flow gradient there.
    warped_ch = warped
    if prior_valid0 is not None:
        warped_ch = jnp.where(
            prior_valid0[:, None], jax.lax.stop_gradient(warped), warped
        )

    # Both chamfer terms ride ONE fused NN pass (4 identical distance sweeps
    # otherwise dominate the train step — ops/nn.py fused_masked_nn).
    chamfer, dyn_chamfer = fused_chamfer_terms(
        warped_ch, pc1, valid0, valid1, dynamic0, dynamic1,
        max_dist=max_dist, dynamic_max_dist=dynamic_max_dist,
    )

    # Object-positive evidence for the static/gate terms: the raw dynamic
    # mask is density-BLIND to a mover's self-overlap interior (NN residuals
    # shrink as sampling densifies; 48-78% coverage measured at 65.4k
    # pts/frame), so supervising "static" with its complement suppresses
    # and gates off true object flow (measured on the 120-epoch headline:
    # gated seflowpp AccS 0.141 -> 0.012, EPE_FD 0.369 -> 0.674 while
    # EPE_BS improved — the gate closed on exactly the interior points).
    # The paint-expanded translation priors (ssl_labels) cover the
    # interior, so their mask completes the positive class.
    obj_pos = dynamic0
    if prior_valid0 is not None:
        obj_pos = obj_pos | prior_valid0
    terms = {
        "chamfer_dis": chamfer,
        "static_flow_loss": static_flow_loss(flow, valid0 & (~obj_pos)),
        "dynamic_chamfer_dis": dyn_chamfer,
        "cluster_based_pc0pc1": cluster_rigidity_loss(
            flow, cluster0, valid0, num_clusters
        ),
    }
    if prior0 is not None:
        terms["prior_flow_loss"] = prior_flow_loss(
            flow, prior0, prior_valid0 & valid0
        )
    if gate_logit0 is not None:
        terms["gate_loss"] = gate_bce_loss(gate_logit0, obj_pos, valid0)
    return _assemble(weights, terms)


def seflowpp_loss_sampled(
    flow: jax.Array,
    pc0: jax.Array,
    pc1: jax.Array,
    valid0: jax.Array,
    valid1: jax.Array,
    dynamic0: jax.Array,
    dynamic1: jax.Array,
    cluster0: jax.Array,
    loss_idx0: jax.Array,  # (K,) int32 sample of pc0 rows for chamfer terms
    loss_idx1: jax.Array,  # (K,) int32 sample of pc1 rows
    num_clusters: int = 64,
    weights: SSLLossWeights = SSLLossWeights(),
    max_dist: float = 2.0,
    dynamic_max_dist: float | None = None,
    prior0: jax.Array | None = None,
    prior_valid0: jax.Array | None = None,
    gate_logit0: jax.Array | None = None,
) -> Dict[str, jax.Array]:
    """seflowpp_loss with SAMPLED Chamfer terms.

    The NN searches are quadratic in cloud size: full 65k-point clouds would
    make the loss NN the largest cost of the step. Gathering K-point subsets for the chamfer terms cuts that
    by (N/K)^2 while the cheap elementwise/segment terms (static flow,
    cluster rigidity, translation prior) stay exact over the full cloud.
    """
    warped = pc0[:, :3] + flow
    # Strong labels beat weak ones — see seflowpp_loss: covered points are
    # chamfer geometry, not chamfer gradient.
    warped_ch = warped
    if prior_valid0 is not None:
        warped_ch = jnp.where(
            prior_valid0[:, None], jax.lax.stop_gradient(warped), warped
        )
    w_l, v0_l = warped_ch[loss_idx0], valid0[loss_idx0]
    d0_l = dynamic0[loss_idx0]
    p1_l, v1_l = pc1[loss_idx1, :3], valid1[loss_idx1]
    d1_l = dynamic1[loss_idx1]

    chamfer, dyn_chamfer = fused_chamfer_terms(
        w_l, p1_l, v0_l, v1_l, d0_l, d1_l,
        max_dist=max_dist, dynamic_max_dist=dynamic_max_dist,
    )
    # Object-positive evidence for the static/gate terms: the raw dynamic
    # mask is density-BLIND to a mover's self-overlap interior (NN residuals
    # shrink as sampling densifies; 48-78% coverage measured at 65.4k
    # pts/frame), so supervising "static" with its complement suppresses
    # and gates off true object flow (measured on the 120-epoch headline:
    # gated seflowpp AccS 0.141 -> 0.012, EPE_FD 0.369 -> 0.674 while
    # EPE_BS improved — the gate closed on exactly the interior points).
    # The paint-expanded translation priors (ssl_labels) cover the
    # interior, so their mask completes the positive class.
    obj_pos = dynamic0
    if prior_valid0 is not None:
        obj_pos = obj_pos | prior_valid0
    terms = {
        "chamfer_dis": chamfer,
        "static_flow_loss": static_flow_loss(flow, valid0 & (~obj_pos)),
        "dynamic_chamfer_dis": dyn_chamfer,
        "cluster_based_pc0pc1": cluster_rigidity_loss(
            flow, cluster0, valid0, num_clusters
        ),
    }
    if prior0 is not None:
        terms["prior_flow_loss"] = prior_flow_loss(
            flow, prior0, prior_valid0 & valid0
        )
    if gate_logit0 is not None:
        terms["gate_loss"] = gate_bce_loss(gate_logit0, obj_pos, valid0)
    return _assemble(weights, terms)
