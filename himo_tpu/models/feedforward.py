"""Feed-forward scene-flow networks: FastFlow3D / DeFlow(++) — the SeFlow++
architecture (SeFlow++ = DeFlow++ net + SSL training, reference
assets/slurm/ssl-train-av2.sh:31-34: ``model=deflowpp``).

Design:
- PointPillars-style dynamic voxelization via segment reductions
  (:mod:`himo_tpu.ops.voxelize`), grid 512x512 @ 0.2 m matching the
  reference training config (``voxel_size=[0.2,0.2,6]``,
  ``point_cloud_range=[-51.2,...]``).
- NHWC convolutional UNet backbone.
- Per-point decoders gather pillar features back and run dense MLP / GRU
  stacks over N-point batches.
- Everything static-shape: padded clouds + valid masks end to end.
- Plain-JAX layers (:mod:`himo_tpu.models.layers`) with flax.linen's
  parameter tree, so checkpoints keep their layout.

Two sweeps (pc0 ego-compensated into the pc1 frame, plus pc1) build two
pseudo-images that the backbone consumes concatenated; a third history sweep
(``num_frames=3``, the ++ variants) adds one more.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from himo_tpu.models.layers import Module, Params, conv, dense, group_norm, gru_cell, relu
from himo_tpu.models.registry import register_estimator
from himo_tpu.ops.refine import RefineConfig
from himo_tpu.ops.voxelize import (
    PillarConfig,
    gather_pillars,
    scatter_max,
    voxelize_pillars,
)


@dataclasses.dataclass(frozen=True)
class FlowNetConfig:
    pillar: PillarConfig = PillarConfig()
    point_feat_dim: int = 32
    base_channels: int = 32
    depths: Tuple[int, ...] = (64, 128, 256)
    decoder: str = "deflow"  # 'linear' (FastFlow3D) | 'deflow' (GRU)
    gru_iters: int = 4
    num_frames: int = 2
    dtype: str = "float32"  # 'bfloat16' for inference/training speed
    # Prior-conditioned variant: feed the verified cluster translation prior
    # (training/ssl_labels.translation_priors) as 3 extra PFN channels for
    # sweep 0 — fast objects beyond the chamfer radius arrive pre-localized,
    # and the prior_flow_loss makes copying a good prior the easy solution.
    prior_feat: bool = False
    # Residual composition on top of the prior: the network's output is
    # ADDED to the prior (flow = prior + gated residual) instead of having
    # to reproduce it from the feature channels. The verified prior is
    # measured motion evidence (matcher median point err ~0.01-0.03 m, vs
    # the 0.05 m strict-accuracy threshold), so the strongest inductive
    # bias is to keep it verbatim and spend network capacity on what the
    # matcher cannot see: residual corrections, uncovered movers, and
    # rotation. The prior bypasses the gate — a miscalibrated gate must not
    # zero a fast object the prior already explains (the prior is zero on
    # static points by construction).
    prior_residual: bool = False
    # Trust the prior VERBATIM where it exists (nonzero): flow = prior on
    # covered points, gated residual elsewhere. Measured motivation
    # (120-epoch headline, covered dynamic points): raw prior err
    # 0.124 mean / 0.026 median, additive-residual output 0.235/0.103 even
    # with the chamfer stop-grad — the pillar decoder's spatial smoothing
    # cannot express "exactly zero here, 1.5 m next pillar", so its
    # residual only pollutes measured motion. Verified-static covered
    # points carry a zero-SNAPPED prior (also correct to emit) but are
    # indistinguishable from uncovered movers by value, so they fall
    # through to the gated residual, which prior_flow_loss trains to zero.
    prior_trust: bool = False
    # In-net per-object rigid decoding (ops/components.py): the UNet emits a
    # per-pillar dynamic logit image; its connected blobs (on-device CC) pool
    # one rigid translation each from the per-point decoder output, and
    # member points emit the POOLED mean instead of their own smooth
    # residual. This is the architectural fix for the round-4 finding that
    # the pillar decoder cannot express sharp per-object motion: training
    # differentiates THROUGH the pooling, so the net only has to get each
    # object's mean right while the dynamic mask supplies the boundary.
    # Requires gate_head (the gate weights the pooling and cuts static
    # points). Replaces the reference's train-time-only SSL clustering with
    # an equivalent inductive bias that survives into pure feed-forward
    # inference.
    instance_head: bool = False
    instance_stride: int = 2  # coarse CC cell = stride x pillar voxel
    instance_reach: int = 2  # Chebyshev connect radius in coarse cells
    instance_iters: int = 24  # label diameter = iters * reach cells
    instance_slots: int = 128  # per-frame component budget
    instance_min_pts: float = 5.0  # min pooling mass to trust a mean
    # BEV correlation cost volume (PWC-style), the large-displacement fix:
    # plain convs cannot regress a 2.5-3.4 m/frame displacement to the 5%
    # strict-accuracy bar from appearance alone (measured round 5: with the
    # instance head isolating every object perfectly — slot_cov 1.00,
    # 1 component/object — the pooled translation was still off by a mean
    # 0.36-0.53 m at every speed; the error was entirely the regression).
    # corr[dy,dx](y,x) = <f0(y,x), f1(y+dy,x+dx)>/C on the PFN pillar
    # images gives the backbone explicit matching evidence: all shifts +
    # elementwise multiplies, no gathers.
    # Two levels: fine (inject after UNet level 0, stride 2, radius
    # corr_radii[0]) and coarse (after the last encoder level, radius
    # corr_radii[1]) — at the production 0.2 m grid that is +-1.6 m at
    # 0.4 m resolution plus +-4.8 m at 1.6 m resolution.
    corr_volume: bool = False
    corr_radii: Tuple[int, int] = (4, 3)
    # On-device per-slot refinement (ops/refine.py): trimmed translation-ICP
    # against the second sweep's dynamic neighborhood, seeded by the instance
    # head's pooled mean, verified by a matched-residual score, with a null
    # test that snaps statics to exact zero. The jittable analog of the host
    # matcher — the network proposes the object mask + a coarse seed, the
    # geometry supplies the measurement. Measurement, not learning: wrapped
    # in stop_gradient and active at inference (``refine`` arg defaults to
    # ``not soft_gate``), so training still differentiates through the
    # pooling. Requires instance_head.
    refine_head: bool = False
    refine: RefineConfig = RefineConfig()
    # Learned static-vs-dynamic gate head (himo_tpu extension): the decoder
    # emits a 4th channel g and the network returns sigmoid(g) * flow.
    # Supervised with BCE against the SSL dynamic mask (losses.gate_loss)
    # while static_flow_loss acts on the GATED output, so static-background
    # fidelity lives in the MODEL — zero residual on static points at
    # inference without any save-path thresholding. Round-3 measurement
    # motivating it: ungated seflowpp smeared static background at
    # EPE_BS 0.138 vs nsfp 0.009 while leading EPE_FD.
    gate_head: bool = False


def point_feature_net(p: Params, points, offsets, dim: int, dtype, extra=None,
                      extra_dim: int = 0):
    """Per-point embedding before pillar pooling (PFN-lite).

    ``extra`` optionally appends conditioning channels — the
    prior-conditioned SeFlow++ variant feeds the verified cluster
    translation prior here (sweep 0 only; other sweeps pass zeros)."""
    # features: xyz, offset-to-pillar-center, radial distance
    r = jnp.linalg.norm(points[:, :2], axis=1, keepdims=True)
    cols = [points[:, :3], offsets, r]
    if extra_dim:
        if extra is None:
            extra = jnp.zeros((points.shape[0], extra_dim), dtype)
        cols.append(extra)
    x = jnp.concatenate(cols, axis=1).astype(dtype)
    x = relu(dense(p["Dense_0"], x, dim, dtype))
    return relu(dense(p["Dense_1"], x, dim, dtype))


def conv_block(p: Params, x, channels: int, dtype, stride: int = 1):
    x = conv(p["Conv_0"], x, channels, strides=(stride, stride), dtype=dtype)
    x = relu(group_norm(p["GroupNorm_0"], x, 8, dtype))
    x = conv(p["Conv_1"], x, channels, dtype=dtype)
    return relu(group_norm(p["GroupNorm_1"], x, 8, dtype))


def _upsample_nearest(x, h: int, w: int):
    """Nearest-neighbor upsample of (..., H, W, C) to (..., h, w, C).

    Integer scale factors go through broadcast + reshape (pure data
    movement XLA fuses well); ``jax.image.resize``'s gather lowering
    is cheaper than the gather lowering. Falls back to resize for
    non-integer ratios."""
    xh, xw = x.shape[-3], x.shape[-2]
    if h % xh == 0 and w % xw == 0:
        fy, fx = h // xh, w // xw
        if fy == fx == 1:
            return x
        x = jnp.broadcast_to(
            x[..., :, None, :, None, :],
            (*x.shape[:-3], xh, fy, xw, fx, x.shape[-1]),
        )
        return x.reshape(*x.shape[:-5], h, w, x.shape[-1])
    return jax.image.resize(x, (*x.shape[:-3], h, w, x.shape[-1]), "nearest")


def _avg_pool(x: jax.Array, stride: int) -> jax.Array:
    """(H, W, C) -> (H/s, W/s, C) mean pool."""
    if stride == 1:
        return x
    h, w, c = x.shape
    return x.reshape(h // stride, stride, w // stride, stride, c).mean((1, 3))


def _bev_correlation(f0: jax.Array, f1: jax.Array, radius: int) -> jax.Array:
    """Local cost volume between two (H, W, C) BEV feature images.

    ``corr[..., k] = <f0(y, x), f1(y+dy, x+dx)> / C`` for every offset in
    the (2r+1)^2 Chebyshev window — zero-padded shift + multiply + channel
    mean, no gathers. Out-of-grid offsets read 0. ``lax.map`` over offsets
    keeps one offset's temporaries live at a time and accumulates the f1
    gradient in the scan carry; the body is checkpointed so the backward
    recomputes each step's shifted slice from the loop-invariant padded
    image instead of stacking all (2r+1)^2 of them as saved residuals
    (f32[81,8,256,256,32] = 21.7 GB at the 512^2 batch-8 train step)."""
    h, w, c = f0.shape
    win = 2 * radius + 1
    f1p = jnp.pad(f1, ((radius, radius), (radius, radius), (0, 0)))

    @jax.checkpoint
    def one(k):
        dy, dx = k // win, k % win
        # k's dtype for the literal too: a python 0 promotes to int64 under
        # jax_enable_x64 (multihost) and dynamic_slice rejects mixed index
        # dtypes.
        zero = jnp.zeros((), k.dtype)
        shifted = jax.lax.dynamic_slice(f1p, (dy, dx, zero), (h, w, c))
        return jnp.sum(f0 * shifted, axis=-1) / c

    cols = jax.lax.map(one, jnp.arange(win * win, dtype=jnp.int32))
    return jnp.moveaxis(cols, 0, -1)


def unet(p: Params, x, depths: Sequence[int], out_channels: int, dtype,
         aux_channels: int = 0, extra=None):
    """Pseudo-image backbone with skip connections.

    ``aux_channels`` appends UN-activated channels to the final conv (the
    instance head's per-pillar dynamic LOGIT must be able to go negative;
    the relu'd feature channels cannot). Returns ``(features, aux)`` when
    aux_channels > 0, ``features`` alone otherwise.

    ``extra`` maps encoder level index -> a feature image at that level's
    resolution, concatenated after the level's conv block (the correlation
    cost volumes enter here, so both the deeper encoder and the decoder
    skip see the matching evidence)."""
    skips = []
    k = 0
    for li, ch in enumerate(depths):
        x = conv_block(p[f"ConvBlock_{k}"], x, ch, dtype, stride=2)
        k += 1
        if extra is not None and li in extra:
            x = jnp.concatenate([x, extra[li].astype(x.dtype)], axis=-1)
        skips.append(x)
    for ch, skip in zip(reversed(depths), reversed(skips)):
        if x is not skip:
            x = _upsample_nearest(x, skip.shape[-3], skip.shape[-2])
            x = jnp.concatenate([x, skip], axis=-1)
        x = conv_block(p[f"ConvBlock_{k}"], x, ch, dtype)
        k += 1
    x = _upsample_nearest(x, x.shape[-3] * 2, x.shape[-2] * 2)
    x = conv(p["Conv_0"], x, out_channels + aux_channels, dtype=dtype)
    if aux_channels:
        return relu(x[..., :out_channels]), x[..., out_channels:]
    return relu(x)


def deflow_gru_decoder(p: Params, pillar_feat, point_feat, hidden: int,
                       iters: int, dtype, gate: bool = False):
    """Iterative voxel-to-point refinement (DeFlow-style GRU).

    With ``gate=True`` the head emits 4 channels — (flow xyz, gate logit) —
    from the shared refined state, so the dynamic evidence the flow needs is
    the same evidence the gate reads."""
    h = dense(p["Dense_0"], pillar_feat, hidden, dtype)
    inp = dense(p["Dense_1"], point_feat, hidden, dtype)
    for _ in range(iters):
        h = gru_cell(p["GRUCell_0"], h, inp, dtype)
    x = relu(dense(p["Dense_2"], h, hidden, dtype))
    out = dense(p["Dense_3"], x, 4 if gate else 3, jnp.float32)
    return (out[:, :3], out[:, 3]) if gate else out


def linear_decoder(p: Params, pillar_feat, point_feat, hidden: int, dtype,
                   gate: bool = False):
    """FastFlow3D-style MLP decoder."""
    x = jnp.concatenate([pillar_feat, point_feat], axis=-1)
    x = relu(dense(p["Dense_0"], x, hidden, dtype))
    x = relu(dense(p["Dense_1"], x, hidden, dtype))
    out = dense(p["Dense_2"], x, 4 if gate else 3, jnp.float32)
    return (out[:, :3], out[:, 3]) if gate else out


@dataclasses.dataclass(frozen=True)
class SceneFlowNet(Module):
    """Full network: pillars -> UNet -> per-point flow for sweep 0."""

    config: FlowNetConfig

    def __call__(
        self, p: Params, sweeps, valids, prior=None, with_gate: bool = False,
        soft_gate: bool = False, with_aux: bool = False,
        refine: Optional[bool] = None, dts=None,
    ):
        """
        Args:
            sweeps: tuple of (N_i, 3) clouds — (pc0_comp, pc1[, pc_hist]);
                flow is predicted for sweeps[0].
            valids: matching validity masks.
            prior: optional (N_0, 3) translation prior for sweep 0
                (``config.prior_feat`` — zeros when absent).
            with_gate: also return the gate LOGITS (input point order) for
                the BCE supervision term; requires ``config.gate_head``.
            soft_gate: multiply flow by sigmoid(gate) instead of the hard
                (> 0.5) cut. Training uses soft (differentiable; the BCE
                saturates it over the run); inference uses HARD — a soft
                0.9 gate would shrink a 3 m dynamic flow by 0.3 m, wrecking
                the strict-accuracy metrics, while the hard cut keeps full
                magnitude on open gates and exact zero on closed ones.
            with_aux: return ``(flow, aux)`` where aux carries the gate
                logits, the instance head's per-pillar dynamic logit image
                (``dyn_logit``, for its BCE supervision), and the per-point
                component slot (``slot``, -1 = none) — superset of
                ``with_gate`` for training/diagnostics.
            refine: run the per-slot geometric refinement
                (``config.refine_head``); defaults to ``not soft_gate`` —
                on for inference, off for the differentiated training pass.
            dts: optional ``(dt0, dt1)`` per-point sweep times for the
                refiner's de-smear regression (ops/refine.py).
        """
        cfg = self.config
        dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
        pfn = p["PointFeatureNet_0"]
        extra_dim = 3 if cfg.prior_feat else 0
        h, w = cfg.pillar.grid_shape

        images = []
        grids = []
        feats = []
        for idx, (pc, valid) in enumerate(zip(sweeps, valids)):
            grid = voxelize_pillars(pc, valid, cfg.pillar)
            extra = None
            if cfg.prior_feat and idx == 0 and prior is not None:
                extra = prior.astype(dtype)
            f = point_feature_net(
                pfn, pc, grid.centers_offset, cfg.point_feat_dim, dtype,
                extra, extra_dim,
            )
            f = jnp.where(grid.in_range[:, None], f, 0.0)
            grids.append(grid)
            feats.append(f)

        images = [scatter_max(f, g) for f, g in zip(feats, grids)]
        x = jnp.concatenate(images, axis=-1).astype(dtype)
        extra = None
        if cfg.corr_volume:
            # Matching evidence for the backbone (see FlowNetConfig.
            # corr_volume): fine + coarse cost volumes between the two
            # sweeps' PFN images, injected at the matching encoder levels.
            f0 = images[0].astype(dtype)
            f1 = images[1].astype(dtype)
            last = len(cfg.depths) - 1
            extra = {}
            fine = _bev_correlation(
                _avg_pool(f0, 2), _avg_pool(f1, 2), cfg.corr_radii[0]
            )
            coarse = _bev_correlation(
                _avg_pool(f0, 2 ** (last + 1)),
                _avg_pool(f1, 2 ** (last + 1)),
                cfg.corr_radii[1],
            )
            if last == 0:
                extra[0] = jnp.concatenate([fine, coarse], axis=-1)
            else:
                extra[0] = fine
                extra[last] = coarse

        def backbone():
            return unet(
                p["UNet_0"], x, cfg.depths, cfg.base_channels * 2, dtype,
                aux_channels=1 if cfg.instance_head else 0, extra=extra,
            )

        slot_img = None
        dyn_logit = None
        if cfg.instance_head:
            if not cfg.gate_head:
                raise ValueError("instance_head requires gate_head")
            from himo_tpu.ops.components import (
                component_slots,
                connected_components_grid,
            )

            out_img, dyn_raw = backbone()
            dyn_logit = dyn_raw[..., 0].astype(jnp.float32)
            s = cfg.instance_stride
            # Coarse occupancy = strided max-pool of the dynamic logits
            # (any dynamic evidence inside the coarse cell keeps it).
            occ = (
                jax.lax.reduce_window(
                    dyn_logit, -jnp.inf, jax.lax.max, (s, s), (s, s), "VALID"
                )
                > 0.0
            )
            labels = connected_components_grid(
                occ, iters=cfg.instance_iters, reach=cfg.instance_reach
            )
            slot_enc, _ = component_slots(labels, cfg.instance_slots)
            # slot+1 encoding (0 = none) survives the zero-masked gather;
            # values <= instance_slots stay exact even through bf16.
            slot_img = _upsample_nearest(
                slot_enc.astype(jnp.float32)[..., None], h, w
            )
        else:
            out_img = backbone()

        slot_pt = None
        img = out_img
        if slot_img is not None:
            img = jnp.concatenate([out_img, slot_img.astype(out_img.dtype)], axis=-1)
        gathered = gather_pillars(img, grids[0])
        if slot_img is not None:
            pillar_feat = gathered[..., :-1].astype(dtype)
            slot_pt = gathered[..., -1].astype(jnp.float32)
        else:
            pillar_feat = gathered.astype(dtype)
        point_feat = feats[0]
        if cfg.decoder == "deflow":
            out = deflow_gru_decoder(
                p["DeFlowGRUDecoder_0"], pillar_feat, point_feat,
                cfg.base_channels * 2, cfg.gru_iters, dtype, gate=cfg.gate_head,
            )
        else:
            out = linear_decoder(
                p["LinearDecoder_0"], pillar_feat, point_feat,
                cfg.base_channels * 2, dtype, gate=cfg.gate_head,
            )
        gate_logit = None
        if cfg.gate_head:
            flow, gate_logit = out
        else:
            flow = out
        flow = flow.astype(jnp.float32)
        slot = None
        if cfg.instance_head:
            # Per-object rigid pooling: member points (in a slotted
            # component, inside the grid) emit their component's
            # gate-weighted mean flow instead of their own smooth residual.
            from himo_tpu.ops.components import pool_by_slot

            slot = jnp.round(slot_pt).astype(jnp.int32) - 1  # -1 = none
            slot = jnp.where(grids[0].in_range, slot, -1)
            gate_w = (
                jax.nn.sigmoid(gate_logit)
                if soft_gate
                else (gate_logit > 0.0).astype(jnp.float32)
            )
            pooled, ok = pool_by_slot(
                flow, gate_w, slot, cfg.instance_slots, cfg.instance_min_pts
            )
            flow = jnp.where(ok[:, None], pooled, flow)
        if cfg.gate_head:
            if soft_gate:
                flow = flow * jax.nn.sigmoid(gate_logit)[:, None]
            else:
                flow = jnp.where((gate_logit > 0.0)[:, None], flow, 0.0)
        if cfg.prior_residual and prior is not None:
            p32 = prior.astype(jnp.float32)
            if cfg.prior_trust:
                # flow = prior where covered, gated residual elsewhere
                # (see FlowNetConfig.prior_trust).
                covered = jnp.any(jnp.abs(p32) > 1e-6, axis=1, keepdims=True)
                flow = jnp.where(covered, p32, flow)
            else:
                # flow = prior + gated residual (FlowNetConfig.prior_residual).
                flow = flow + p32
        if (
            cfg.instance_head
            and cfg.refine_head
            and (refine if refine is not None else not soft_gate)
        ):
            # Geometric verification pass (see FlowNetConfig.refine_head):
            # confident slots emit the ICP-refined translation — overriding
            # the pooled mean, the gate, AND the prior (a wrong host prior
            # is corrected by the measurement; an unverifiable one is kept).
            from himo_tpu.ops.refine import refine_flow

            w0 = gate_w
            if cfg.prior_residual and prior is not None:
                w0 = jnp.maximum(
                    w0,
                    jnp.any(
                        jnp.abs(prior.astype(jnp.float32)) > 1e-6, axis=1
                    ).astype(jnp.float32),
                )
            flow = refine_flow(
                flow, sweeps[0][:, :3].astype(jnp.float32), slot, valids[0],
                w0, sweeps[1][:, :3].astype(jnp.float32), valids[1],
                dyn_logit, grids[1].pillar_ids, grids[1].in_range,
                cfg.instance_slots, cfg.refine,
                dt0=None if dts is None else dts[0],
                dt1=None if dts is None else dts[1],
            )
        flow = jnp.where(valids[0][:, None], flow, 0.0)
        if with_aux:
            aux = {}
            if gate_logit is not None:
                aux["gate_logit"] = gate_logit.astype(jnp.float32)
            if dyn_logit is not None:
                aux["dyn_logit"] = dyn_logit
            if slot is not None:
                aux["slot"] = slot
            return flow, aux
        if with_gate:
            if gate_logit is None:
                raise ValueError("with_gate=True requires config.gate_head")
            return flow, gate_logit.astype(jnp.float32)
        return flow


def make_model(name: str, **overrides) -> Tuple[SceneFlowNet, FlowNetConfig]:
    """Build a preset network; overrides may be dataclass values OR dotted
    CLI-style keys into nested configs (``pillar.voxel_size=(0.4,0.4)``)."""
    from himo_tpu.utils.config import apply_overrides

    presets = {
        "fastflow3d": dict(decoder="linear", num_frames=2),
        "deflow": dict(decoder="deflow", num_frames=2),
        "deflowpp": dict(decoder="deflow", num_frames=3),
        # The SSL flagships carry the learned static-vs-dynamic gate head:
        # SSL training's chamfer pulls static points toward sensor noise
        # (measured round 3: EPE_BS 0.138 on the ungated flagship), and the
        # gate — trained against the same SSL dynamic evidence the losses
        # already use — zeroes static residual in the model itself.
        #
        # ``seflowpp`` is the reference-parity deployment profile: a PURE
        # feed-forward net — SSL cluster evidence (dynamic masks + verified
        # translation priors) supervises TRAINING only, inference touches no
        # host clustering (/root/reference/assets/slurm/ssl-train-av2.sh:
        # 31-34 feeds +ssl_label at train time; README.md:46-53's save.py is
        # a net forward). The per-object capacity the reference net learns
        # from 110k real frames is built in architecturally instead: the
        # instance head (ops/components.py) pools one rigid translation per
        # predicted-dynamic blob, on device, inside the same jit.
        "seflowpp": dict(
            decoder="deflow", num_frames=3, gate_head=True, instance_head=True,
            corr_volume=True, refine_head=True,
        ),
        # Ablation: same recipe without the instance head (the pre-round-5
        # point-wise decoder; the correlation volume stays, so the ablation
        # isolates the head) — its delta against seflowpp is the in-net
        # per-object pooling's contribution.
        "seflowpp_noprior": dict(
            decoder="deflow", num_frames=3, gate_head=True, corr_volume=True,
        ),
        # ``seflowpp_trust`` is the OFFLINE/labeling hybrid (round 4's
        # flagship, renamed — its quality is partly the host matcher's, not
        # the network's, so it must not collide with the reference's pure
        # feed-forward SeFlow++ name): the verified cluster translation
        # prior — computed on the host from the same (pc0, pc1) pair by the
        # fleet producer (parallel/fleet.frame_to_arrays), 0.2-1.2 s/frame —
        # enters as 3 PFN channels, as the residual base, and is emitted
        # VERBATIM on covered points (prior_trust). Use it where label
        # quality beats latency: autolabeling, dataset refinement.
        # Round 5 adds the instance + refine heads to the hybrid too: the
        # host prior is still emitted verbatim where nothing better is
        # known, but slots the on-device ICP verifies emit the MEASURED
        # translation instead — wrong matcher priors (21 of 324 fast
        # frame-instances at 65k, round-4 diagnostic) get corrected by
        # geometry rather than trusted blindly.
        "seflowpp_trust": dict(
            decoder="deflow", num_frames=3, gate_head=True,
            prior_feat=True, prior_residual=True, prior_trust=True,
            corr_volume=True, instance_head=True, refine_head=True,
        ),
        "seflow": dict(decoder="deflow", num_frames=2, gate_head=True),
        # Back-compat alias (pre-round-4 name of the prior-conditioned net;
        # feature-channels only — no residual composition, no gate head, so
        # pre-round-4 checkpoints restore unchanged).
        "seflowpp_prior": dict(
            decoder="deflow", num_frames=3, prior_feat=True
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown feed-forward model {name!r}")
    config = FlowNetConfig(**presets[name])
    if overrides:
        config = apply_overrides(config, overrides)
    return SceneFlowNet(config), config


def init_params(model: SceneFlowNet, key, num_points: int = 1024):
    n_sweeps = model.config.num_frames
    sweeps = tuple(jnp.zeros((num_points, 3)) for _ in range(n_sweeps))
    valids = tuple(jnp.ones((num_points,), bool) for _ in range(n_sweeps))
    prior = jnp.zeros((num_points, 3)) if model.config.prior_feat else None
    return model.init(key, sweeps, valids, prior)


def _feedforward_estimator(name: str):
    """Registry adapter: feed-forward models need trained params; the
    estimator closes over (model, params) loaded from a checkpoint."""

    def factory(checkpoint: Optional[str] = None, params=None, **overrides):
        model, config = make_model(name, **overrides)
        if params is None:
            if checkpoint is None:
                raise ValueError(
                    f"feed-forward estimator {name!r} needs checkpoint= or params="
                )
            from himo_tpu.training.checkpoints import load_checkpoint

            params = load_checkpoint(checkpoint)["params"]

        @jax.jit
        def _estimate(pc0, pc1, valid0, valid1, key=None, history=None,
                      prior=None, dts=None):
            sweeps = [pc0[:, :3], pc1[:, :3]]
            valids = [valid0, valid1]
            if config.num_frames >= 3:
                if history is None:
                    sweeps.append(jnp.zeros_like(pc0[:, :3]))
                    valids.append(jnp.zeros_like(valid0))
                else:
                    sweeps.append(history[0][:, :3])
                    valids.append(history[1])
            flow = model.apply(
                params, tuple(sweeps), tuple(valids), prior, dts=dts
            )
            return flow, jnp.zeros(())

        trackers = {}  # per-scene velocity continuity for the prior channel

        def estimate(pc0, pc1, valid0, valid1, key=None, history=None,
                     dt0=None, dt1=None, scene_id=None, pose1=None):
            prior = None
            if config.prior_feat:
                from himo_tpu.models.icp_flow import ClusterTracker
                from himo_tpu.models.nsfp import cluster_prior_flow

                tracker = None
                if scene_id is not None and pose1 is not None:
                    tracker = trackers.setdefault(scene_id, ClusterTracker())
                prior = cluster_prior_flow(
                    pc0, pc1, valid0, valid1,
                    dt0=dt0, dt1=dt1, tracker=tracker, pose1=pose1,
                )
            dts = None
            if config.refine_head and dt0 is not None and dt1 is not None:
                dts = (jnp.asarray(dt0), jnp.asarray(dt1))
            return _estimate(pc0, pc1, valid0, valid1, key, history, prior,
                             dts)

        # Let callers (models/runner.py) know how many sweeps to feed.
        estimate.num_frames = config.num_frames
        estimate.trackers = trackers  # runner's scene-start repair
        return estimate

    return factory


for _name in (
    "fastflow3d", "deflow", "deflowpp", "seflow", "seflowpp",
    "seflowpp_noprior", "seflowpp_trust", "seflowpp_prior",
):
    register_estimator(_name)(_feedforward_estimator(_name))
