"""On-device per-slot translation refinement: trimmed ICP + null test.

The jittable analog of the host matcher's trimmed translation-ICP
(``models/icp_flow.match_cluster_translations``): each predicted-dynamic
component (``ops/components.py`` slot) seeds a translation from its pooled
mean flow, a few NN trimmed-mean iterations against the other sweep's
dynamic neighborhood refine it, a matched-residual score accepts or rejects
the result, and a null test snaps statics to exact zero. Pure feed-forward:
everything runs inside the same jit as the network — no host clustering,
matching the reference's deployment profile (a checkpointed net forward,
/root/reference/README.md:46-53; SSL cluster evidence is train-time only,
/root/reference/assets/slurm/ssl-train-av2.sh:31-34).

Measured motivation (round 5): with the instance head isolating every
object (slot coverage 1.00, one component per object) the pooled
REGRESSION was still off by a mean 0.36-0.53 m at every speed — appearance
convs cannot hit the 5% strict-accuracy bar at 2.5-3.4 m/frame. Geometry
can: matching against the second sweep IS the measurement, and the network
only has to propose the object mask and a coarse seed.

Design:
- Fixed-size subsets via stable argsort selection (static shapes under
  jit; invalid rows masked, never branched on).
- The NN search (``ops/nn.py``) on (K0 x K1) subsets — a few 4k x 8k
  passes per frame.
- Per-slot reductions as one-hot matmuls at HIGHEST precision
  (bf16 truncation must not bias an object's translation); no unsorted
  scatters anywhere.
- The whole refiner is wrapped in ``stop_gradient``: it is measurement,
  not learnable computation — training still differentiates through the
  instance head's pooling (the net must keep proposing good seeds).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from himo_tpu.ops.nn import nn_argmin, nn_distance_sq


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    num_query: int = 4096  # pc0 member-point subset (covers 6x400..1400 objs)
    num_ref: int = 8192  # pc1 dynamic-neighborhood subset
    # Shrinking inlier radii (m), one NN pass each. Rolling-shutter smear
    # stretches every object into a slab along its motion (up to |v|*T =
    # 3.4 m here), so NN correspondences can SLIDE along the smear; the
    # per-slot residual-on-dt regression below (the host matcher's de-smear,
    # models/icp_flow.py sweep-time regression) collapses that degeneracy —
    # the radii only have to bound the search, not carry the convergence.
    taus: Tuple[float, ...] = (2.0, 1.2, 0.8, 0.5, 0.4, 0.35, 0.3, 0.3)
    # Translation-ICP on extended surfaces contracts slowly along the
    # object's own long axis (only end-face pairs pull; measured ~0.85/iter
    # on synthetic car boxes). Two fixes, both measured to matter: inlier
    # weights proportional to matched distance (anchors pull harder —
    # err at 8 iters 0.22 -> 0.05 on a 2.5 m/frame box), and a scalar
    # per-slot Aitken step at these iteration indices (the update sequence
    # is near-geometric, so u * alpha/(1-alpha) jumps to the fixed point;
    # elementwise Aitken overshoots on axis-mixed sequences — measured
    # err1 0.51 -> 1.27 — the scalar projection does not).
    accel_iters: Tuple[int, ...] = (3, 6)
    min_inliers: float = 6.0  # per-slot matched-pair mass to accept an update
    cap: float = 1.0  # residual cap (m) for the score/null means
    accept: float = 0.35  # max capped mean matched residual (m) to trust
    null_margin: float = 1.15  # snap to zero when m0 <= md*margin + null_abs
    null_abs: float = 0.03
    snap_delta: float = 0.04  # |delta| below the eval's dynamic threshold
    dilate_cells: int = 24  # pc1 neighborhood reach around dynamic pillars
    dilate_pool: int = 4  # coarse stride for the dilation window


def select_topk(mask: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Indices of up to ``k`` True entries of ``mask`` (stable order) plus a
    validity mask for the selected rows (False rows are padding)."""
    order = jnp.argsort(jnp.logical_not(mask), stable=True).astype(jnp.int32)
    idx = order[:k]
    return idx, jnp.take(mask, idx)


def dilated_dynamic_mask(
    dyn_logit: jax.Array,  # (H, W) per-pillar dynamic logits
    pillar_ids: jax.Array,  # (M,) flat pillar index per pc1 point
    in_range: jax.Array,  # (M,) bool
    reach_cells: int,
    pool: int = 4,
) -> jax.Array:
    """Per-pc1-point mask: within ``reach_cells`` pillars of dynamic
    evidence. Dilation runs on a ``pool``-strided coarse grid (separable
    windowed max), sized so a displaced object's pc1 footprint
    still falls inside its pc0-frame dynamic blob's neighborhood."""
    h, w = dyn_logit.shape
    occ = (dyn_logit > 0.0).astype(jnp.float32)
    coarse = occ.reshape(h // pool, pool, w // pool, pool).max((1, 3))
    r = max(1, reach_cells // pool)
    win = 2 * r + 1
    coarse = jax.lax.reduce_window(
        coarse, -jnp.inf, jax.lax.max, (win, 1), (1, 1), "SAME"
    )
    coarse = jax.lax.reduce_window(
        coarse, -jnp.inf, jax.lax.max, (1, win), (1, 1), "SAME"
    )
    cw = w // pool
    y = jnp.clip(pillar_ids // w, 0, h - 1) // pool
    x = jnp.clip(pillar_ids % w, 0, w - 1) // pool
    hit = jnp.take(coarse.reshape(-1), y * cw + x) > 0.0
    return hit & in_range


def _slot_mean(
    onehot: jax.Array,  # (K, S) f32 membership
    values: jax.Array,  # (K, C)
    weights: jax.Array,  # (K,)
) -> Tuple[jax.Array, jax.Array]:
    """Weighted per-slot mean via one matmul: ((S, C) means, (S,) mass)."""
    aug = jnp.concatenate(
        [values * weights[:, None], weights[:, None]], axis=1
    )
    sums = jax.lax.dot_general(
        onehot, aug, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    mass = sums[:, -1]
    return sums[:, :-1] / jnp.maximum(mass, 1e-6)[:, None], mass


def refine_slot_translations(
    q: jax.Array,  # (K0, 3) selected pc0 member points
    qslot: jax.Array,  # (K0,) slot in [0, S) (invalid rows: anything)
    qvalid: jax.Array,  # (K0,) bool
    seed: jax.Array,  # (S, 3) per-slot seed translations
    seed_ok: jax.Array,  # (S,) bool — slots with real pooled seeds
    r: jax.Array,  # (K1, 3) selected pc1 reference points
    rvalid: jax.Array,  # (K1,) bool
    max_slots: int,
    cfg: RefineConfig = RefineConfig(),
    qdt: jax.Array | None = None,  # (K0,) pc0 per-point sweep times (s)
    rdt: jax.Array | None = None,  # (K1,) pc1 per-point sweep times (s)
    period: float = 0.1,  # sweep period (s)
):
    """Refine per-slot translations by de-smeared trimmed NN ICP.

    Rolling-shutter smear stretches a mover into a slab of length
    ``|v| * period``; NN correspondences between two such slabs can slide
    freely along the motion, so neither a trimmed mean nor a residual-on-dt
    regression converges (measured here AND on the host,
    models/icp_flow._refine_translation). The fix is the host matcher's:
    de-smear BOTH clouds with the current delta before matching — the slabs
    collapse back to sharp surfaces whose end faces anchor the translation.
    Per-slot de-smear needs per-point slots on the reference side too: a
    one-time reverse-NN claim pass (r -> seeded q) inherits each reference
    point's nearest member's slot.

    In de-smeared coordinates a true pair's residual obeys exactly
    ``resid = e * (1 + ddt/period)`` with ``e`` the remaining delta error
    and ``ddt = rdt[nn] - qdt`` — one scalar regressor with no intercept
    ambiguity — so the update is the per-slot weighted least squares
    ``e = sum(resid * z) / sum(z^2)``, ``z = 1 + ddt/period``: five extra
    columns in the same one-hot matmul as a plain mean. Without dts,
    z = 1 everywhere and the update degrades to the trimmed mean.

    Returns ``(delta (S, 3), conf (S,), snapped (S,))``: ``conf`` marks
    slots whose refined translation is geometrically verified (enough
    matched inliers, capped mean de-smeared residual under ``cfg.accept``);
    ``snapped`` marks confident slots the null test proved static
    (``delta`` is exactly zero there). Non-confident slots keep their seed
    in ``delta`` but must not be used (callers fall back to the network
    flow)."""
    onehot = (
        (qslot[:, None] == jnp.arange(max_slots, dtype=jnp.int32)[None, :])
        & qvalid[:, None]
    ).astype(jnp.float32)
    qf = q.astype(jnp.float32)
    delta = seed.astype(jnp.float32)
    if qdt is None:
        qdt = jnp.zeros(qf.shape[0], jnp.float32)
    if rdt is None:
        rdt = jnp.zeros(r.shape[0], jnp.float32)
    qdt = qdt.astype(jnp.float32)
    rdt = rdt.astype(jnp.float32)
    qslot_safe = jnp.clip(qslot, 0, max_slots - 1)
    rf = r.astype(jnp.float32)

    # Claim pass: each reference point inherits the slot of its nearest
    # SEEDED member, so it can be de-smeared with that slot's velocity.
    # Unclaimed references (no member within 2*tau0) stay matchable but
    # un-de-smeared — the trim rejects them once the slabs sharpen.
    seed_shift = jnp.take(delta, qslot_safe, axis=0)
    d2r, nnq = nn_argmin(rf, qf + seed_shift, query_valid=rvalid,
                         ref_valid=qvalid)
    rslot = jnp.take(qslot_safe, nnq)
    claim_tau = 2.0 * cfg.taus[0]
    rclaimed = rvalid & (d2r < claim_tau * claim_tau)
    rslot = jnp.where(rclaimed, rslot, 0)
    rdesmear_w = rclaimed.astype(jnp.float32)[:, None] * (
        rdt[:, None] / period
    )

    def _coords(delta):
        # De-smeared coordinates at the current delta (host _desmear):
        # q' = q - delta*qdt/T + delta, r' = r - delta_rslot*rdt/T.
        qs = qf + jnp.take(delta, qslot_safe, axis=0) * (
            1.0 - qdt[:, None] / period
        )
        rs = rf - jnp.take(delta, rslot, axis=0) * rdesmear_w
        return qs, rs

    def _pass(delta):
        qs, rs = _coords(delta)
        d2, nn = nn_argmin(qs, rs, query_valid=qvalid, ref_valid=rvalid)
        resid = jnp.take(rs, nn, axis=0) - qs
        ddt = jnp.take(rdt, nn) - qdt
        # Same-object pairing: a member may only learn from reference
        # points its own slot claimed (structural outlier rejection — a
        # hard distance trim would discard exactly the end-face anchor
        # pairs that carry the along-axis translation signal once the
        # remaining error exceeds the trim radius).
        same = (jnp.take(rslot, nn) == qslot_safe) & jnp.take(rclaimed, nn)
        return d2, resid, ddt, same

    prev_u = None
    for it, tau in enumerate(cfg.taus):
        d2, resid, ddt, same = _pass(delta)
        dist = jnp.sqrt(jnp.maximum(d2, 0.0))
        w0 = (qvalid & same).astype(jnp.float32)
        # Per-slot adaptive radius: 3x the slot's capped mean matched
        # distance, floored by the schedule — shrinks with convergence but
        # never below the scale of the remaining error (a hard shrinking
        # trim would discard the anchors exactly when they matter).
        m_s, _ = _slot_mean(
            onehot, jnp.minimum(dist, cfg.cap)[:, None], w0
        )
        tau_s = jnp.clip(3.0 * m_s[:, 0], tau, cfg.taus[0])
        w = w0 * (dist < jnp.take(tau_s, qslot_safe)).astype(jnp.float32)
        w = w * (dist + 0.05)  # anchor pairs (large residual) pull harder
        z = 1.0 + ddt / period
        # Per-slot WLS of resid = e*z in ONE matmul: [resid*z, z^2, w].
        aug = jnp.concatenate(
            [resid * z[:, None], (z * z)[:, None], jnp.ones_like(z)[:, None]],
            axis=1,
        ) * w[:, None]
        sums = jax.lax.dot_general(
            onehot, aug, (((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # (S, 5): sum(resid*z)(3), sum(z^2), n
        e = sums[:, 0:3] / jnp.maximum(sums[:, 3], 1e-6)[:, None]
        # n counts weighted pairs; w carries the distance factor, so gate
        # acceptance on the unweighted same-slot mass instead.
        _, n_pairs = _slot_mean(onehot, resid, w0)
        ok = (n_pairs >= cfg.min_inliers) & seed_ok
        u = jnp.where(ok[:, None], e, 0.0)
        delta = delta + u
        if prev_u is not None and it in cfg.accel_iters:
            # Scalar per-slot Aitken: contraction alpha from consecutive
            # updates, jump by the geometric tail u * alpha/(1-alpha).
            dot = jnp.sum(u * prev_u, axis=1)
            nrm = jnp.sum(prev_u * prev_u, axis=1)
            alpha = jnp.clip(dot / jnp.maximum(nrm, 1e-8), 0.0, 0.9)
            boost = jnp.clip(u * (alpha / (1.0 - alpha))[:, None], -1.0, 1.0)
            delta = delta + boost
            u = u + boost
        prev_u = u

    # Score pass: capped mean matched de-smeared residual at the refined
    # translation, over ALL member points (not just inliers — a delta that
    # only explains half its object must not look confident). Min-only
    # kernel: the score never needs the argmin index, and the argmin
    # variant costs 2.3x the min pass (TODO.md chip measurement).
    qs_f, rs_f = _coords(delta)
    d2_f = nn_distance_sq(qs_f, rs_f, query_valid=qvalid, ref_valid=rvalid)
    rcap = jnp.minimum(jnp.sqrt(jnp.maximum(d2_f, 0.0)), cfg.cap)
    md, mass_f = _slot_mean(onehot, rcap[:, None], qvalid.astype(jnp.float32))
    md = md[:, 0]
    # Null pass: the same score at delta = 0. If zero explains the match as
    # well as the refined translation, the component is static — emit EXACT
    # zero (the host matcher's null/snap veto, on device). Uses _pass so
    # the residual/dt pairs come out too (fixed-point veto below).
    d2_0, resid0, ddt0, same0 = _pass(jnp.zeros_like(delta))
    r0 = jnp.minimum(jnp.sqrt(jnp.maximum(d2_0, 0.0)), cfg.cap)
    m0, _ = _slot_mean(onehot, r0[:, None], qvalid.astype(jnp.float32))
    m0 = m0[:, 0]
    # Fixed-point veto on the null: a raw small zero-offset residual is NOT
    # evidence of rest under heavy rolling-shutter smear — at |v|*T ~
    # displacement the two slabs overlap, so m0 is small for a genuinely
    # moving object (measured round 5: 15-24 m/s crossing / stop-and-go
    # movers were snapped to exact zero, slot coverage 1.00, gate open).
    # The de-smeared WLS is smear-proof: regressing resid = e*(1+ddt/T)
    # from the ZERO seed still recovers the motion, so zero is only a
    # credible hypothesis when it is (approximately) a fixed point of the
    # regression.
    dist0 = jnp.sqrt(jnp.maximum(d2_0, 0.0))
    w0n = (qvalid & same0).astype(jnp.float32) * (
        dist0 < cfg.taus[0]
    ).astype(jnp.float32)
    z0 = 1.0 + ddt0 / period
    aug0 = jnp.concatenate(
        [resid0 * z0[:, None], (z0 * z0)[:, None]], axis=1
    ) * w0n[:, None]
    sums0 = jax.lax.dot_general(
        onehot, aug0, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    e0 = sums0[:, 0:3] / jnp.maximum(sums0[:, 3], 1e-6)[:, None]
    null_fixed = jnp.linalg.norm(e0, axis=1) <= jnp.maximum(
        0.5 * jnp.linalg.norm(delta, axis=1), cfg.snap_delta
    )

    conf = seed_ok & (mass_f >= cfg.min_inliers) & (md < cfg.accept)
    small = jnp.linalg.norm(delta, axis=1) < cfg.snap_delta
    null_wins = (m0 <= md * cfg.null_margin + cfg.null_abs) & null_fixed
    snapped = conf & (small | null_wins)
    delta = jnp.where(snapped[:, None], 0.0, delta)
    return delta, conf, snapped


def refine_flow(
    flow: jax.Array,  # (N, 3) network output (post gate / prior composition)
    p0: jax.Array,  # (N, 3) sweep-0 points (ego-compensated)
    slot: jax.Array,  # (N,) int32 component slot, -1 = none
    valid0: jax.Array,  # (N,) bool
    weight0: jax.Array,  # (N,) seed-pooling weight (gate prob / coverage)
    p1: jax.Array,  # (M, 3) sweep-1 points
    valid1: jax.Array,  # (M,) bool
    dyn_logit: jax.Array,  # (H, W) per-pillar dynamic logits
    pillar_ids1: jax.Array,  # (M,) flat pillar id per pc1 point
    in_range1: jax.Array,  # (M,) bool
    max_slots: int,
    cfg: RefineConfig = RefineConfig(),
    dt0: jax.Array | None = None,  # (N,) pc0 per-point sweep times (s)
    dt1: jax.Array | None = None,  # (M,) pc1 per-point sweep times (s)
) -> jax.Array:
    """Replace member-point flow with the geometrically verified per-slot
    translation wherever refinement is confident; keep the network flow
    (with its gradients) elsewhere. The refinement itself is pure
    measurement — every internal input is ``stop_gradient``-ed, but the
    unrefined fallback keeps the original differentiable flow."""
    flow_sg, p0, p1 = (
        jax.lax.stop_gradient(flow),
        jax.lax.stop_gradient(p0),
        jax.lax.stop_gradient(p1),
    )
    dyn_logit = jax.lax.stop_gradient(dyn_logit)
    weight0 = jax.lax.stop_gradient(weight0)

    member = (slot >= 0) & valid0
    idx0, qvalid = select_topk(member, cfg.num_query)
    q = jnp.take(p0, idx0, axis=0)
    qslot = jnp.clip(jnp.take(slot, idx0), 0, max_slots - 1)
    qflow = jnp.take(flow_sg, idx0, axis=0)
    qw = jnp.take(weight0, idx0)
    qdt = None if dt0 is None else jnp.take(jax.lax.stop_gradient(dt0), idx0)

    onehot = (
        (qslot[:, None] == jnp.arange(max_slots, dtype=jnp.int32)[None, :])
        & qvalid[:, None]
    ).astype(jnp.float32)
    seed, seed_mass = _slot_mean(onehot, qflow.astype(jnp.float32), qw)
    seed_ok = seed_mass >= cfg.min_inliers

    ref_mask = dilated_dynamic_mask(
        dyn_logit, pillar_ids1, in_range1, cfg.dilate_cells, cfg.dilate_pool
    ) & valid1
    idx1, rvalid = select_topk(ref_mask, cfg.num_ref)
    r = jnp.take(p1, idx1, axis=0)
    rdt = None if dt1 is None else jnp.take(jax.lax.stop_gradient(dt1), idx1)

    delta, conf, _ = refine_slot_translations(
        q, qslot, qvalid, seed, seed_ok, r, rvalid, max_slots, cfg,
        qdt=qdt, rdt=rdt,
    )
    safe = jnp.clip(slot, 0, max_slots - 1)
    use = member & jnp.take(conf, safe)
    per_pt = jnp.take(delta, safe, axis=0)
    return jnp.where(use[:, None], per_pt, flow)
