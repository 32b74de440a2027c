"""ICP-Flow — cluster-and-register scene flow (h5 key ``icpflow``).

Capability parity with the reference's ``icpflow`` baseline (method list at
tools/view_instance.py:155-157): dynamic points are clustered, and each
cluster is rigidly registered against the next sweep with ICP; its rigid
transform becomes the flow of its points (static points keep zero residual).

Host/device split:
- clustering stays on host (DBSCAN, a data-prep-scale cost);
- ALL cluster ICPs run as one jitted, vmapped program: every iteration does
  a batched correspondence search via the NN-argmin search and a
  weighted Kabsch (3x3 SVD) per cluster — ``lax.scan`` over iterations,
  static cluster count/capacity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from himo_tpu.models.registry import register_estimator
from himo_tpu.ops.nn import nn_argmin


@dataclasses.dataclass(frozen=True)
class ICPFlowConfig:
    max_clusters: int = 32
    cluster_capacity: int = 1024
    icp_iters: int = 12
    max_corr_dist: float = 2.0
    # Looser DBSCAN than round 2 (0.8/10): sparse objects at range fragment
    # under tight eps, and fragments mismatch across sweeps. Measured on the
    # bucket-complete suite: eps 1.0 / min_samples 5 took per-point dynamic
    # EPE 1.16 -> 0.65, capacity 1024 -> 0.61 (big TRUCK clusters truncated
    # at 512 lost half their points).
    dbscan_eps: float = 1.0
    dbscan_min_samples: int = 5
    dynamic_threshold: float = 0.18
    # Fast-object handling (HiMo's target regime): clusters moving 2.5-3.4 m
    # between sweeps find no correspondences inside the 2 m ICP gate, so (a)
    # pc1's dynamic points are clustered too and each pc0 cluster's
    # translation is INITIALIZED from its matched pc1 centroid (greedy 1-1,
    # gated at ``match_gate`` meters = ~45 m/s at 10 Hz), and (b) the
    # correspondence gate anneals from ``coarse_corr_dist`` down to
    # ``max_corr_dist`` over the ICP iterations.
    match_gate: float = 6.0
    coarse_corr_dist: float = 4.0


def weighted_kabsch(src: jax.Array, dst: jax.Array, w: jax.Array):
    """Weighted rigid alignment src -> dst. Returns (R, t).

    Falls back to identity when fewer than 3 effective correspondences."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    wn = (w / wsum)[:, None]
    cs = jnp.sum(src * wn, axis=0)
    cd = jnp.sum(dst * wn, axis=0)
    a = (src - cs) * wn
    b = dst - cd
    h = a.T @ b  # (3, 3)
    u, _, vt = jnp.linalg.svd(h)
    det = jnp.linalg.det(vt.T @ u.T)
    d = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(det)
    rot = vt.T @ d @ u.T
    t = cd - rot @ cs
    ok = jnp.sum(w) >= 3.0
    rot = jnp.where(ok, rot, jnp.eye(3))
    t = jnp.where(ok, t, jnp.zeros(3))
    return rot, t


@partial(jax.jit, static_argnames=("config",))
def icp_register_clusters(
    clusters: jax.Array,  # (C, K, 3)
    cluster_valid: jax.Array,  # (C, K)
    pc1: jax.Array,  # (M, 3)
    valid1: jax.Array,  # (M,)
    config: ICPFlowConfig = ICPFlowConfig(),
    init_t: jax.Array | None = None,  # (C, 3) translation seeds
):
    """Per-cluster rigid registration; returns per-cluster-point flow (C, K, 3).

    ``init_t`` seeds each cluster's translation (from centroid matching of
    dynamic clusters across the sweeps) so fast clusters start inside the
    correspondence gate; the gate itself anneals ``coarse_corr_dist`` ->
    ``max_corr_dist`` geometrically over the iterations.

    Also returns each cluster's rigid ``(rot, t)`` so callers can apply the
    transform to points that did not fit the registration slots — a close
    full-density truck exceeds any fixed ``cluster_capacity``, and the
    overflow points deserve the cluster's rigid flow, not zero (verdict-r3
    density item; the registration itself subsamples, rigidity covers the
    rest)."""
    if init_t is None:
        init_t = jnp.zeros((clusters.shape[0], 3), jnp.float32)
    fine = config.max_corr_dist
    coarse = max(config.coarse_corr_dist, fine)
    it = jnp.arange(config.icp_iters, dtype=jnp.float32)
    frac = it / jnp.maximum(config.icp_iters - 1.0, 1.0)
    caps2 = (coarse * (fine / coarse) ** frac) ** 2  # (icp_iters,)

    pc1 = pc1.astype(jnp.float32)

    def one(pts, mask, t0):
        # float32 carry whatever the inputs' dtype (jax_enable_x64).
        pts = pts.astype(jnp.float32)

        def body(carry, cap2):
            rot, t = carry
            moved = pts @ rot.T + t
            d2, idx = nn_argmin(moved, pc1, mask, valid1)
            corr = pc1[idx]
            w = (mask & (d2 < cap2)).astype(jnp.float32)
            rot2, t2 = weighted_kabsch(pts, corr, w)
            return (rot2.astype(jnp.float32), t2.astype(jnp.float32)), d2

        init = (jnp.eye(3, dtype=jnp.float32), t0.astype(jnp.float32))
        (rot, t), _ = jax.lax.scan(body, init, caps2)
        flow = pts @ rot.T + t - pts
        return jnp.where(mask[:, None], flow, 0.0), rot, t

    return jax.vmap(one)(clusters, cluster_valid, init_t)


def _desmear(
    pts: np.ndarray, dt, delta: np.ndarray, period: float
) -> np.ndarray:
    """Undo the rolling-shutter smear of a rigidly translating cluster.

    A point captured ``dt`` seconds into its sweep sits ``v * dt`` ahead of
    the cluster's sweep-start position; with ``delta = v * period`` the
    sweep-start cloud is ``pts - delta * dt / period``. This is HiMo's own
    compensation model (core/compensation.py) applied INSIDE the matching
    loop: at 25 m/s the smear is 2.5 m long and translation-ICP on the raw
    smears can slide along the motion axis (measured ~0.5 m bias on
    verified-correct matches)."""
    if dt is None:
        return pts[:, :3]
    return pts[:, :3] - np.asarray(delta, np.float32)[None, :] * (
        np.asarray(dt, np.float32)[:, None] / period
    )


def _nn_query_fn(pts: np.ndarray):
    from himo_tpu import native

    if native.available():
        return native.KDTree(pts[:, :3]).query
    from scipy.spatial import cKDTree

    tree = cKDTree(pts[:, :3])
    return lambda q: tree.query(q, k=1)


def _refine_translation(
    pts0: np.ndarray,
    pts1: np.ndarray,
    delta: np.ndarray,
    iters: int = 3,
    trim_pct: float = 75.0,
    dt0=None,
    dt1=None,
    period: float = 0.1,
) -> np.ndarray:
    """Trimmed translation-only ICP refinement of a cluster-pair delta.

    Each round queries NNs of the shifted pts0 in pts1, keeps the closest
    ``trim_pct`` percent of pairs (coverage mismatch between the frames'
    clusters otherwise biases the step), and moves by their mean residual
    vector. With per-point sweep times (``dt0``/``dt1``) both clusters are
    DE-SMEARED with the current delta each round (see :func:`_desmear`) and
    the update becomes a sweep-time regression: a delta wrong by ``e``
    still finds geometric matches — but only along the slice of pairs with
    ``dt0 - dt1 ~ period`` (the residual of a matched pair obeys
    ``r = e * (1 - (dt0 - dt1)/period)``, so the motion smear admits a
    CONTINUUM of (delta, correspondence) solutions and the plain mean
    update inherits whatever slice the NN matching favored). Regressing the
    kept residual vectors on ``dt0 - dt1`` and stepping by the intercept at
    ``dt0 - dt1 = 0`` cancels that bias: at the true delta the trend is
    zero and the update degrades gracefully to the mean."""
    delta = np.asarray(delta, np.float32).copy()
    with_dt = dt0 is not None and dt1 is not None
    if with_dt:
        iters = max(iters, 5)  # delta also feeds the de-smear: iterate more
        dt0 = np.asarray(dt0, np.float32)
        dt1 = np.asarray(dt1, np.float32)
    for _ in range(iters):
        q1 = _desmear(pts1, dt1, delta, period)
        query = _nn_query_fn(q1)
        shifted = _desmear(pts0, dt0, delta, period) + delta
        dist, idx = query(shifted)
        keep = dist <= np.percentile(dist, trim_pct)
        if not keep.any():
            break
        r = q1[idx[keep]] - shifted[keep]
        if with_dt:
            ddt = dt0[keep] - dt1[idx[keep]]
            ddt_c = ddt - ddt.mean()
            var = float((ddt_c**2).mean()) + (0.02) ** 2
            beta = (r * ddt_c[:, None]).mean(0) / var
            delta = delta + (r.mean(0) - beta * ddt.mean())
        else:
            delta = delta + r.mean(0)
    return delta.astype(np.float32)


def _trimmed_mean(d: np.ndarray, frac: float) -> float:
    """Mean of the smallest ``frac`` fraction (coverage-mismatch between the
    frames' clusters puts a far tail on the residuals of TRUE matches; a
    light trim removes it without hiding a genuinely wrong alignment)."""
    if frac >= 1.0 or len(d) < 5:
        return float(d.mean())
    k = max(1, int(round(frac * len(d))))
    return float(np.partition(d, k - 1)[:k].mean())


def _pair_alignment_error(
    pts0: np.ndarray,
    pts1: np.ndarray,
    delta: np.ndarray,
    dt0=None,
    dt1=None,
    period: float = 0.1,
    trim: float = 1.0,
    bwd_keep=None,
) -> float:
    """Two-sided mean NN residual of the aligned (de-smeared) cluster pair.

    ``bwd_keep`` (bool over pts1) restricts the pts1 -> pts0 direction to
    the window points that constitute MOTION evidence: callers exclude
    points already zero-explained by the claim's raw neighborhood (a slow
    merged sibling's self-overlap, the unflagged interior). Without it a
    partial claim verified against a complete window fails on residuals it
    was never supposed to explain (measured: a 34 m/s member of a merged
    pc1 cluster at err 0.528 vs tol 0.517 purely on its slow sibling's bwd
    residuals). A blanket coverage-ratio bwd trim was tried instead and
    measured WORSE: it forgave cross-object alias claims wholesale (every
    junk candidate verified at err <= 0.37, and reassignment then handed a
    third of the member's points to a 2.9 m-off alias). Keeping only the
    must-move points preserves the discrimination: a wrong-object match
    still faces the wrong object's own displaced body."""
    from himo_tpu.training.ssl_labels import nn_residual_distances

    shifted = _desmear(pts0, dt0, delta, period) + delta
    q1 = _desmear(pts1, dt1, delta, period)
    fwd = nn_residual_distances(shifted, q1)
    q1b = q1 if bwd_keep is None else q1[np.asarray(bwd_keep, bool)]
    if len(q1b) == 0:
        return float(_trimmed_mean(fwd, trim))
    bwd = nn_residual_distances(q1b, shifted)
    return float(max(_trimmed_mean(fwd, trim), _trimmed_mean(bwd, trim)))


def motion_beats_null(
    pts0: np.ndarray,
    pc0_full: np.ndarray,
    pc1_full: np.ndarray,
    delta: np.ndarray,
    dt0=None,
    dt0_full=None,
    dt1_full=None,
    period: float = 0.1,
    expand: float = 0.5,
    trim: float = 0.7,
    ratio: float = 0.75,
    exclude=None,
) -> str:
    """Zero-motion NULL TEST for a cluster's motion claim.

    A spurious delta on re-sampled sparse STATIC structure arises from
    biased subset selection: the dynamic mask flags only the worst-sampled
    shards of the surface, and aligning frame A's shard with frame B's
    (different) shard produces a real ~0.6 m offset that verifies within
    the density-aware tolerance (measured: tests/test_matcher_stress.py
    stop-and-go, delta 0.59 at verify err 0.39). Point-level local
    thresholds cannot fix this — static-resample and fast-smear-interior
    residual/spacing ratios overlap (p50 1.0 vs 1.7, measured).

    The cluster-level falsifier: expand the claimed subset with the pc0
    points around it (the under-threshold rest of the object) and score the
    trimmed one-sided alignment error against the raw local pc1 window
    under the claimed delta AND under zero. A true mover's full body aligns
    only under its delta (the null leaves the whole smear unexplained); a
    static shard's neighborhood aligns BETTER under zero. ``trim`` absorbs
    adjacent static contamination (wall/ground points inside the expanded
    set fail under the true delta). ``exclude`` (bool over pc0_full) bars
    points from the expansion — pass OTHER clusters' points, or two
    converging objects bridge into one evidence set whose halves misfit
    under either true delta (measured: crossing objects ~3 m apart both
    demoted at the closest pair).

    Returns a verdict:
      - ``'motion'``    — the delta explains the evidence clearly better;
      - ``'static'``    — zero motion genuinely fits (emit a zero claim:
        the object is matched and did not move);
      - ``'ambiguous'`` — NEITHER fits (e.g. the pair violates the
        constant-velocity smear model). Callers should drop the claim
        rather than assert static."""
    from himo_tpu.training.ssl_labels import nn_residual_distances

    delta = np.asarray(delta, np.float32)
    p0 = np.asarray(pc0_full)[:, :3]
    # Expand the claim with its connected neighborhood — TRANSITIVELY, at a
    # radius scaled to the claim's own sampling spacing. The claim set is
    # SELECTION-BIASED (the dynamic mask flagged exactly the points whose
    # zero-motion residual is high), so judging on it alone lets a fitted
    # spurious delta beat the null by construction (measured: shard claim
    # err_d 0.133 vs err_0 0.194 on a fully static object at one 0.5 m
    # hop). Three spacing-scaled hops pull in the under-threshold rest of
    # the object, diluting the bias with unbiased evidence.
    r_hop = float(min(max(expand, 2.5 * _cluster_spacing(pts0)), 1.5))
    lo = pts0[:, :3].min(0) - 3 * r_hop
    hi = pts0[:, :3].max(0) + 3 * r_hop
    nearby = np.all((p0 >= lo) & (p0 <= hi), axis=1)
    if exclude is not None:
        nearby &= ~np.asarray(exclude, bool)
    cand_ix = np.flatnonzero(nearby)
    in_set = np.zeros(len(cand_ix), bool)
    if len(cand_ix):
        seed = pts0[:, :3]
        for _ in range(3):
            rest = ~in_set
            if not rest.any() or len(seed) == 0:
                break
            d_near = nn_residual_distances(p0[cand_ix[rest]], seed)
            grew = np.zeros(len(cand_ix), bool)
            grew[np.flatnonzero(rest)[d_near <= r_hop]] = True
            if not grew.any():
                break
            in_set |= grew
            seed = p0[cand_ix[in_set]]
    cand_ix = cand_ix[in_set]
    if len(cand_ix) >= len(pts0):
        exp0 = p0[cand_ix]
        exp_dt0 = None if dt0_full is None else np.asarray(dt0_full)[cand_ix]
    else:  # degenerate fallback: the claim is its own neighborhood
        exp0 = pts0[:, :3]
        exp_dt0 = dt0
    # pc1 window: everything the object could cover under either hypothesis.
    p1 = np.asarray(pc1_full)[:, :3]
    lo = np.minimum(exp0.min(0), exp0.min(0) + delta) - 1.0
    hi = np.maximum(exp0.max(0), exp0.max(0) + delta) + 1.0
    inwin = np.all((p1 >= lo) & (p1 <= hi), axis=1)
    if inwin.sum() < 4:
        return "motion"  # no null evidence either way; keep the claim
    win1 = p1[inwin]
    win_dt1 = None if dt1_full is None else np.asarray(dt1_full)[inwin]

    # ONE-SIDED error (claim -> raw window): the window holds background the
    # object never explains, so the reverse direction would penalize both
    # hypotheses with irrelevant unexplained points.
    def err_under(d):
        shifted = _desmear(exp0, exp_dt0, d, period) + d
        q1 = _desmear(win1, win_dt1, d, period)
        return _trimmed_mean(nn_residual_distances(shifted, q1), trim)

    err_d = err_under(delta)
    err_0 = err_under(np.zeros(3, np.float32))
    if err_d < ratio * err_0:
        return "motion"
    # The null wins only if it FITS in absolute terms — within the expanded
    # set's own resampling noise (~its sampling spacing). Otherwise neither
    # hypothesis explains the pair (constant-velocity smear model violated,
    # heavy occlusion, ...): ambiguous, no claim either way.
    if err_0 <= max(0.3, 0.75 * _cluster_spacing(exp0)):
        return "static"
    return "ambiguous"


def _histogram_delta_candidates(
    pts0: np.ndarray,
    pool1: np.ndarray,
    match_gate: float,
    bin_size: float = 0.5,
    max_src: int = 48,
    top_k: int = 3,
    dt0=None,
    pool_dt1=None,
    period: float = 0.1,
) -> list:
    """Candidate translations from a BEV offset histogram.

    The role of ICP-Flow's histogram translation initialization: every
    (pc0-cluster point, nearby pc1 dynamic point) pair votes a translation
    hypothesis into a ``bin_size`` grid; the densest bins are hypotheses
    that need no pc1 cluster to exist (DBSCAN may have merged or missed
    the target object).

    With sweep times the vote is SMEAR-EXACT: a same-surface pair obeys
    ``p1 - p0 = delta * (1 + (dt1 - dt0)/period)``, so each pair votes the
    implied ``delta = (p1 - p0) / (1 + ddt/period)`` — every same-object
    pair then lands in the true delta's bin (the raw offset smears votes
    over ``delta ± delta`` and large close objects drown the true peak in
    blend bins — measured on the merged-convoy scenes). Returns up to
    ``top_k`` (3,) float32 deltas."""
    if len(pts0) == 0 or len(pool1) == 0:
        return []
    step = max(1, len(pts0) // max_src)
    src = pts0[::step][:max_src, :3]
    rel = pool1[None, :, :3] - src[:, None, :3]  # (n0, n1, 3)
    if dt0 is not None and pool_dt1 is not None:
        sdt = np.asarray(dt0, np.float32)[::step][:max_src]
        scale = 1.0 + (
            np.asarray(pool_dt1, np.float32)[None, :] - sdt[:, None]
        ) / period  # (n0, n1)
        good = scale > 0.3  # near-zero scale => unbounded implied delta
        rel = np.where(
            good[:, :, None], rel / np.maximum(scale, 0.3)[:, :, None], np.inf
        )
    rel = rel.reshape(-1, 3)
    keep = np.isfinite(rel[:, 0]) & (
        np.linalg.norm(rel[:, :2], axis=1) <= match_gate
    )
    rel = rel[keep]
    if len(rel) == 0:
        return []
    ij = np.floor(rel[:, :2] / bin_size).astype(np.int64)
    key = (ij[:, 0] + (1 << 20)) << 21 | (ij[:, 1] + (1 << 20))
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    order = np.argsort(-counts)[:top_k]
    out = []
    for b in order:
        if counts[b] < 3:
            break
        m = inv == b
        out.append(rel[m].mean(0).astype(np.float32))
    return out


class ClusterTracker:
    """World-frame cluster tracks: velocity continuity across a scene.

    Single-frame cluster matching is fundamentally ambiguous for identical
    vehicles in formation: mapping vehicle A onto neighbor B's next-sweep
    points is geometrically as good as the true match (same shape, same
    smear), and the swapped delta is off by the full A-B offset (measured
    3.4-5.3 m on the benchmark's convoy scenes). Velocity continuity breaks
    the tie: a track carries (predicted position, per-frame delta) in WORLD
    coordinates; at the next frame its delta re-enters the matcher as a
    candidate with a scoring preference, so the track-consistent hypothesis
    wins unless verification genuinely rejects it. Tracks coast unmatched
    for ``max_coast`` frames (re-acquisition through short occlusions).
    """

    def __init__(self, max_coast: int = 2):
        # {"pos_w": (3,), "delta_w": (3,), "age": int, "hits": int,
        #  "meas_w": (3,), "meas_hits": int}
        # delta_w is the POST-null motion claim (what priors supervise);
        # meas_w is the matcher's MEASURED delta BEFORE null demotion /
        # sub-resolution snap. The two diverge exactly for slow movers
        # (~0.3-1 m/frame): their measured deltas sit inside the
        # verification tolerance, so single-frame evidence cannot tell
        # them from re-sampled static structure and the null zeroes them
        # — but a fabricated delta has RANDOM direction per frame, while
        # a real slow mover's measured deltas agree frame over frame.
        # meas_hits counts that agreement; >= 1 is physical motion
        # evidence noise can't fake (see measured_track_consistent).
        self.tracks = []
        self.max_coast = max_coast

    def predict(self, pose1: np.ndarray) -> list:
        """Per track: (position, delta, confirmed) with position/delta in
        the current frame pair's pc1-ego frame (the matcher's coordinates);
        ``confirmed`` = the track agreed with an accepted match on >= 2
        consecutive frames. ``pose1`` = world <- ego1."""
        R = np.asarray(pose1[:3, :3], np.float64)
        t = np.asarray(pose1[:3, 3], np.float64)
        return [
            (
                (R.T @ (tr["pos_w"] - t)).astype(np.float32),
                (R.T @ tr["delta_w"]).astype(np.float32),
                tr["hits"] >= 1,
            )
            for tr in self.tracks
        ]

    def predict_measured(self, pose1: np.ndarray) -> list:
        """Per track: (position, MEASURED delta, measured-confirmed) in the
        pc1-ego frame. measured-confirmed = the matcher measured agreeing
        pre-null deltas on >= 2 consecutive frames (see __init__) — the
        velocity-continuity evidence that lets a slow mover's sub-tolerance
        motion survive the zero-motion null."""
        R = np.asarray(pose1[:3, :3], np.float64)
        t = np.asarray(pose1[:3, 3], np.float64)
        return [
            (
                (R.T @ (tr["pos_w"] - t)).astype(np.float32),
                (R.T @ tr.get("meas_w", tr["delta_w"])).astype(np.float32),
                tr.get("meas_hits", 0) >= 1,
            )
            for tr in self.tracks
        ]

    def update(self, assigned: list, pose1: np.ndarray) -> None:
        """Replace tracks with this frame's accepted matches and coast the
        unconfirmed remainder. ``assigned`` = (centroid_ego1, delta_ego1)
        pairs; the stored position is the PREDICTED next-frame location
        (centroid + delta), which is what the next pair's pc0 clusters sit
        at. A new track inherits ``hits + 1`` from an old track it agrees
        with (predicted position within 1.5 m AND delta within 0.6 m) —
        that confirmation is what gates the matcher's ranking preference,
        so a wrong single-frame match at a scene start cannot outrank
        geometry on the very next frame (it must win independently once
        more before its track does)."""
        R = np.asarray(pose1[:3, :3], np.float64)
        t = np.asarray(pose1[:3, 3], np.float64)
        new = []
        for entry in assigned:
            # (centroid, delta) or (centroid, delta, measured) — measured
            # is the matcher's pre-null/pre-snap delta (defaults to delta).
            c, d = entry[0], entry[1]
            m = entry[2] if len(entry) > 2 else d
            meas_w = R @ np.asarray(m, np.float64)
            # Position prediction uses the MEASURED delta: a slow mover
            # demoted to zero still physically advances, and predicting
            # with the zeroed claim would lag its track by |meas|/frame.
            pos_w = R @ (np.asarray(c, np.float64) + np.asarray(m, np.float64)) + t
            delta_w = R @ np.asarray(d, np.float64)
            hits = 0
            meas_hits = 0
            for tr in self.tracks:
                pred = tr["pos_w"] + tr.get("meas_w", tr["delta_w"])
                if np.linalg.norm(pred - pos_w) >= 1.5:
                    continue
                if np.linalg.norm(tr["delta_w"] - delta_w) < 0.6:
                    hits = max(hits, tr["hits"] + 1)
                # Measured-motion agreement: tighter than the claim bound
                # (a fabricated sub-tolerance delta has random direction
                # per frame; 0.25 m absolute / 35% relative separates
                # persistence from chance) and only for genuine motion
                # (> 0.3 m/frame = 3 m/s).
                m_old = tr.get("meas_w", tr["delta_w"])
                m_norm = float(np.linalg.norm(meas_w))
                if m_norm > 0.3 and float(
                    np.linalg.norm(m_old - meas_w)
                ) <= max(0.25, 0.35 * m_norm):
                    meas_hits = max(
                        meas_hits, tr.get("meas_hits", 0) + 1
                    )
            new.append(
                {"pos_w": pos_w, "delta_w": delta_w, "age": 0, "hits": hits,
                 "meas_w": meas_w, "meas_hits": meas_hits}
            )
        for tr in self.tracks:
            if tr["age"] + 1 > self.max_coast:
                continue
            pred = tr["pos_w"] + tr.get("meas_w", tr["delta_w"])
            if any(np.linalg.norm(pred - n["pos_w"]) < 1.5 for n in new):
                continue  # confirmed (or superseded) by a fresh track
            new.append(
                {
                    "pos_w": pred,
                    "delta_w": tr["delta_w"],
                    "age": tr["age"] + 1,
                    "hits": tr["hits"],
                    "meas_w": tr.get("meas_w", tr["delta_w"]),
                    "meas_hits": tr.get("meas_hits", 0),
                }
            )
        self.tracks = new

    def backcast(self, n_frames: int) -> "ClusterTracker":
        """Tracker for RE-LABELING a scene's first pair from later evidence.

        Labels are an offline artifact, so a scene start — where no track
        exists and convoy/blend ambiguities have nothing to overrule them
        — can borrow velocity continuity from the FUTURE: fresh confirmed
        tracks (age 0, hits >= 1, i.e. two consecutive later pairs agreed
        independently of the first pair's own matches) are rolled back
        ``n_frames`` periods under constant velocity. After pair k a fresh
        track's ``pos_w`` is the object's time-(k+1) position, so pass
        ``n_frames = k + 1`` to land on the frame-0 position the first
        pair's ego-compensated pc0 clusters sit at."""
        out = ClusterTracker(max_coast=self.max_coast)
        out.tracks = [
            {
                # Roll back along the MEASURED velocity when it is
                # confirmed — a slow mover's claim delta is zero but the
                # object did move between frame 0 and now.
                "pos_w": tr["pos_w"] - n_frames * (
                    tr.get("meas_w", tr["delta_w"])
                    if tr.get("meas_hits", 0) >= 1 else tr["delta_w"]
                ),
                "delta_w": tr["delta_w"],
                "age": 0,
                "hits": tr["hits"],
                "meas_w": tr.get("meas_w", tr["delta_w"]),
                "meas_hits": tr.get("meas_hits", 0),
            }
            for tr in self.tracks
            if tr["age"] == 0 and (
                tr["hits"] >= 1 or tr.get("meas_hits", 0) >= 1
            )
        ]
        return out


def measured_track_consistent(
    delta,
    center,
    track_meas,
    min_speed: float = 0.3,
    pos_gate: float = 3.0,
) -> bool:
    """True when a MEASURED-confirmed track near ``center`` agrees with
    ``delta`` (see ClusterTracker.predict_measured).

    This is the veto that lets a slow mover's sub-tolerance motion survive
    the zero-motion demotions (null test, sub-resolution snap): a single
    frame cannot tell a real 0.3-1 m/frame delta from re-sampled static
    structure, but a fabricated delta has random direction per frame while
    a real mover's measured deltas persist. The agreement bound is tighter
    than the claim-track bound (0.25 m absolute / 35% relative, capped at
    the 0.6 m claim bound) and only genuine motion (> ``min_speed``
    m/frame) qualifies — a confirmed STATIC track must keep agreeing with
    the null, not shelter sub-tolerance claims from it."""
    delta = np.asarray(delta, np.float32)
    center = np.asarray(center, np.float32)[:3]
    for pos, md, conf in track_meas:
        if not conf:
            continue
        md = np.asarray(md, np.float32)
        mdn = float(np.linalg.norm(md))
        if mdn <= min_speed:
            continue
        if float(
            np.linalg.norm(np.asarray(pos, np.float32)[:3] - center)
        ) > pos_gate:
            continue
        if float(np.linalg.norm(md - delta)) <= min(
            0.6, max(0.25, 0.35 * mdn)
        ):
            return True
    return False


def _cluster_spacing(pts: np.ndarray) -> float:
    """Median NN spacing within a cluster via an odd/even split (scan order
    is spatially sequential, so the halves interleave)."""
    from himo_tpu.training.ssl_labels import nn_residual_distances

    if len(pts) < 4:
        return np.inf
    return float(np.median(nn_residual_distances(pts[0::2], pts[1::2])))


def _connected_body(
    pc0: np.ndarray, labels0: np.ndarray, cid: int, eligible0=None
):
    """Cluster ``cid``'s points plus its hop-connected unlabeled
    neighborhood (training/ssl_labels.complete_cluster_bodies on a
    single-cluster view): the zero-explanation reference for
    :func:`recover_split_translations` — the object's own body including
    the under-threshold interior, but not background or other clusters.

    ``eligible0`` (the caller's non-ground mask) keeps ground out of the
    completion — complete_cluster_bodies' hop spacing assumes non-ground
    density, and absorbed ground beneath an object would zero-explain
    nearby pool points and weaken the must-move check."""
    from himo_tpu.training.ssl_labels import complete_cluster_bodies

    labels0 = np.asarray(labels0)
    one = np.where(labels0 == cid, 1, 0).astype(np.uint16)
    eligible = labels0 == 0
    if eligible0 is not None:
        eligible = eligible & np.asarray(eligible0, bool)
    completed = complete_cluster_bodies(pc0, one, eligible)
    return pc0[completed > 0]


def recover_split_translations(
    pts0: np.ndarray,
    pool1: np.ndarray,
    match_gate: float,
    verify_tol: float = 0.45,
    spacing_factor: float = 1.75,
    dt0=None,
    pool_dt1=None,
    period: float = 0.1,
    min_points: int = 8,
    max_candidates: int = 4,
    extra_candidates=(),
    trim: float = 1.0,
    track_deltas=(),
    track_meas=(),
    pool_labels=None,
    cand_mask=None,
    zero_ref=None,
    measured_out=None,
    debug: bool = False,
) -> list:
    """Translation recovery for a pc0 cluster with no 1-1 pc1 cluster match,
    directly against nearby RAW dynamic pc1 points.

    ``pool_labels`` (optional int labels over ``pool1``, 0 = unclustered)
    restricts each candidate's VERIFICATION window to the pc1 cluster(s)
    its own inliers matched into, plus unclustered pool points. Without it
    a completed pc1 pool (see training/ssl_labels.complete_cluster_bodies)
    vetoes true claims: a merged pc0 cluster's member claim has a sibling
    object's completed interior inside its bbox window, and the two-sided
    bwd residual counts that foreign body as unexplained (measured at 65.4k
    pts/frame: a 34 m/s member of a 2-object cluster lost EVERY candidate
    at verification; window-restricting by matched label recovers it
    without weakening the same-model discrimination the two-sided test
    exists for — a wrong-object claim still faces its full wrong object).

    Two failure modes of cluster-level matching land here: the target's pc1
    points never formed their own DBSCAN cluster (sparse returns / merged
    with a neighbor), and the pc0 cluster itself holds SEVERAL objects
    (density-adaptive eps merges adjacent vehicles on sparse frames).
    Candidate deltas come from a BEV offset histogram
    (:func:`_histogram_delta_candidates` — the role of ICP-Flow's histogram
    translation initialization); each candidate is ICP-refined, claims the
    de-smeared-aligned INLIER SUBSET of the cluster, and is verified
    two-sided against the pool points inside the aligned subset's bounding
    box (+0.8 m margin). A merged two-object cluster thus yields two deltas
    over disjoint point subsets instead of one wrong average.

    Each candidate is refined on its OWN raw inlier subset (full-cluster
    refinement drifts every candidate toward a blend of a merged cluster's
    motions), verified, then deltas are ACCEPTED by greedy total-residual
    gain with a unique-support test, and points are ASSIGNED by raw
    residual with confirmed-tier precedence and body-proximity tie-breaks
    — the inline comments below document each mechanism with the measured
    failure mode that forced it.

    Returns a list of ``(delta (3,) float32, local_mask (len(pts0),) bool)``
    in claim order; masks are disjoint."""
    from himo_tpu.training.ssl_labels import nn_residual_distances

    if len(pts0) < min_points or len(pool1) == 0:
        return []
    dt0 = None if dt0 is None else np.asarray(dt0)
    # Candidate VOTING runs on TWO views of the pool and unions the
    # results, because each view misses a measured true delta the other
    # finds (verification arbitrates; extra candidates only cost
    # evaluation time):
    # - movement-evidence-only votes (``cand_mask`` = the original dynamic
    #   flags): a completed pool's interior points flood the histogram
    #   with blend/slow bins and a merged cluster's fast member never
    #   reaches the top-k (measured: four blend candidates, true delta
    #   absent);
    # - full completed-pool votes: a smeared object whose dynamic strip is
    #   thin votes its true bin only through interior same-surface pairs
    #   (measured: dynamic-only votes for a 25 m/s object were ALL from
    #   the 1.66-2.14x smear-alias family).
    vote_sels = [np.ones(len(pool1), bool)]
    if cand_mask is not None and not np.asarray(cand_mask, bool).all():
        vote_sels.append(np.asarray(cand_mask, bool))
    cands = [np.asarray(td) for td, _ in track_deltas] + list(extra_candidates)
    for vote_sel in vote_sels:
        vote_dt1 = None if pool_dt1 is None else np.asarray(pool_dt1)[vote_sel]
        cands += _histogram_delta_candidates(
            pts0, pool1[vote_sel], match_gate, top_k=max_candidates,
            dt0=dt0, pool_dt1=vote_dt1, period=period,
        )
        if pool_labels is not None:
            # Per-pc1-cluster candidates: a small member can drown under a
            # big neighbor in the GLOBAL top-k; one top-1 histogram per
            # labeled pool cluster guarantees every nearby object
            # contributes a candidate. Junk dies in verification as usual.
            pl_ = np.asarray(pool_labels)
            for cid in np.unique(pl_[pl_ > 0]):
                sel = (pl_ == cid) & vote_sel
                if sel.sum() < min_points:
                    continue
                cands += _histogram_delta_candidates(
                    pts0, pool1[sel], match_gate, top_k=1,
                    dt0=dt0,
                    pool_dt1=(
                        None if pool_dt1 is None
                        else np.asarray(pool_dt1)[sel]
                    ),
                    period=period,
                )
    # Dedup near-identical candidates (each costs refine + verify).
    kept = []
    for c in cands:
        c = np.asarray(c, np.float32)
        if not any(np.linalg.norm(c - k) <= 0.3 for k in kept):
            kept.append(c)
    cands = kept

    # ONE claim radius for every candidate, from the RAW pool's spacing.
    # Candidate-dependent radii are a perverse incentive: de-smearing with
    # the TRUE delta compacts the smear (denser pool, smaller radius, lower
    # gain) while a wrong delta leaves it smeared (inflated radius/gain) —
    # measured flipping a 34 m/s object's claim to a slow neighbor's delta.
    # Spacing-scaled radii/tolerances are CAPPED at 1.0 m: they exist so
    # genuinely sparse objects (0.4-0.8 m returns at range) still match, but
    # uncapped they lose all discriminative power on subsample-artifact
    # junk — at ~1.4 m spacing the tolerance reaches ~2.4 m and ANY wrong
    # pairing verifies (measured: junk false-dynamic clusters poisoning
    # static points with >=1 m priors on 2048-point clouds).
    r_in = min(max(verify_tol, 1.5 * _cluster_spacing(pool1)), 1.0)
    tol_shared = min(
        max(verify_tol, spacing_factor * _cluster_spacing(pool1)), 1.0
    )

    def residuals_of(delta):
        """Per-point NN residual of the de-smeared aligned cluster into the
        de-smeared pool. Delta-INSENSITIVE pairs are marked inf: a pc0
        point at sweep time ``dt0 ~ period`` matched to a pc1 point at
        ``dt1 ~ 0`` has de-smear scale ``1 + (dt1 - dt0)/period ~ 0`` — its
        positions coincide under ANY delta (the object really is at the
        same place at both capture times), so it carries no delta evidence
        and must not vote, claim, or seed ghost tracks (measured: a
        spurious delta claiming exactly such a slice of a 25 m/s convoy
        pair, then outliving it as a track). They are backfilled spatially
        after assignment. Returns (gated, raw) residuals: the RAW ones
        still define refinement inliers — under the true delta an
        insensitive pair is a perfectly good geometric correspondence, and
        dropping a systematic dt tail biases the sweep-time regression
        (measured +0.11 m median prior error)."""
        aligned = _desmear(pts0, dt0, delta, period) + delta
        q1 = _desmear(pool1, pool_dt1, delta, period)
        if dt0 is None or pool_dt1 is None:
            d = nn_residual_distances(aligned, q1)
            return d, d
        dist, idx = _nn_query_fn(q1)(aligned)
        sens = np.abs(
            1.0 + (np.asarray(pool_dt1, np.float32)[idx] - dt0) / period
        )
        gated = np.where(sens >= 0.35, dist, np.inf).astype(np.float32)
        return gated, np.asarray(dist, np.float32)

    # Pool points zero-explained by the RAW local pc0 neighborhood
    # (``zero_ref``; falls back to the cluster itself): a slow merged
    # sibling's self-overlap, the under-threshold interior, adjacent
    # static structure. These are not MOTION evidence — no claim has to
    # explain them (see _pair_alignment_error's bwd_keep rationale), and
    # their complement is the must-move mass the big-delta physics check
    # below weighs. The FULL neighborhood matters: against the cluster
    # alone, the parts of a slow object the dynamic mask missed count as
    # must-move and shelter fabricated large deltas (measured on the
    # sparse slow-mover stress scene).
    zero_expl_pool = nn_residual_distances(
        pool1, pts0 if zero_ref is None else zero_ref
    ) <= r_in

    def evaluate(cand, bwd_excl_pool):
        """Refine + verify one candidate. Returns (delta, res, res_raw) on
        acceptance, or None with a 'retryable' flag (failed only on bwd
        residuals another claim might explain).

        Claims the RAW candidate's inlier subset before ANY refinement:
        refining on the full (possibly merged multi-object) cluster first
        drifts every candidate toward a blend of the members' motions —
        the trimmed regression keeps pairs from both objects — and the
        blend then claims a mixed subset. Histogram candidates are
        bin-accurate (+-0.25 m), inside the claim radius, so the raw
        subset is already object-pure; two refine/re-inlier rounds then
        converge on that object alone."""
        res, res_raw = residuals_of(np.asarray(cand, np.float32))
        inl = res_raw <= r_in
        if inl.sum() < min_points:
            if debug:
                print(f"  [recover] cand {np.round(cand, 2)}: raw inliers "
                      f"{int(inl.sum())} < {min_points}")
            return None, False
        delta = np.asarray(cand, np.float32)
        for _ in range(2):
            ipts = pts0[inl]
            idt = None if dt0 is None else dt0[inl]
            delta = _refine_translation(
                ipts, pool1, delta, dt0=idt, dt1=pool_dt1, period=period
            )
            res, res_raw = residuals_of(delta)
            inl = res_raw <= r_in
            if inl.sum() < min_points:
                break
        if inl.sum() < min_points:
            if debug:
                print(f"  [recover] cand {np.round(cand, 2)} -> "
                      f"{np.round(delta, 2)}: refined inliers died")
            return None, False
        # Verify two-sided against the pool points inside the aligned
        # subset's bbox — a merged neighbor object outside the box cannot
        # inflate the residual.
        ipts = pts0[inl]
        idt = None if dt0 is None else dt0[inl]
        aligned = _desmear(ipts, idt, delta, period) + delta
        q1 = _desmear(pool1, pool_dt1, delta, period)
        lo, hi = aligned.min(0) - 0.8, aligned.max(0) + 0.8
        inbox = np.all((q1 >= lo) & (q1 <= hi), axis=1)
        if pool_labels is not None and inbox.any():
            # Window-restrict to the cluster(s) this claim's inliers hit
            # (>= 5% of inliers each — one stray pair must not admit a
            # neighbor's whole body), plus unclustered points.
            _, nn_ix = _nn_query_fn(q1)(aligned)
            hit = np.asarray(pool_labels)[nn_ix]
            ids, cnt = np.unique(hit[hit > 0], return_counts=True)
            keep_ids = ids[cnt >= max(3, 0.05 * len(aligned))]
            pl_ = np.asarray(pool_labels)
            inbox &= (pl_ == 0) | np.isin(pl_, keep_ids)
        win = pool1[inbox]
        win_dt = None if pool_dt1 is None else np.asarray(pool_dt1)[inbox]
        if len(win) < 4:
            if debug:
                print(f"  [recover] cand {np.round(cand, 2)} -> "
                      f"{np.round(delta, 2)}: window < 4")
            return None, False
        bwd_keep = ~(zero_expl_pool | bwd_excl_pool)[inbox]
        # Physics check: a window with (almost) no must-move evidence means
        # nothing here actually moved — a delta far beyond the claim radius
        # is then self-contradictory (if the object had moved that far, a
        # strip of pc1 HAS to be far from every pc0 point). Measured: a
        # 1.5 m/s slow mover on a sparse cloud acquired a fabricated 1.26 m
        # prior whose sparse-resample alignment scored under the
        # spacing-scaled tolerance and whose magnitude sat above the null
        # test's 2x-tolerance entry gate.
        mm_frac = (~zero_expl_pool[inbox]).sum() / max(int(inbox.sum()), 1)
        if float(np.linalg.norm(delta)) > 2.0 * r_in and mm_frac < 0.1:
            if debug:
                print(f"  [recover] cand {np.round(cand, 2)} -> "
                      f"{np.round(delta, 2)}: big delta, must-move frac "
                      f"{mm_frac:.2f} < 0.1 — self-contradictory")
            return None, False
        # With little must-move evidence (a slow/static neighborhood), face
        # the claim with the FULL window instead of an emptied bwd.
        if bwd_keep.sum() < max(4, 0.1 * int(inbox.sum())):
            bwd_keep = np.ones(int(inbox.sum()), bool)
        err = _pair_alignment_error(
            ipts, win, delta, dt0=idt, dt1=win_dt, period=period, trim=trim,
            bwd_keep=bwd_keep,
        )
        # ONE tolerance for every candidate, from the shared pool's spacing
        # (like r_in). Per-WINDOW spacing is a perverse incentive mirroring
        # the claim-radius note above: a blend delta's window straddles two
        # objects' strips (sparser composition -> larger spacing -> looser
        # tolerance) while the true deltas' compact windows judge them
        # strictly (measured: truths at err 0.72 vs their tol 0.71 FAILING
        # while the blend passed 0.715 vs ITS tol 0.735, so the blend
        # outranked both siblings' round-2 recoveries).
        tol = tol_shared
        if debug:
            print(f"  [recover] cand {np.round(cand, 2)} -> "
                  f"{np.round(delta, 2)}: inl {int(inl.sum())} win "
                  f"{int(inbox.sum())} err {err:.3f} tol {tol:.3f} "
                  f"{'PASS' if err <= tol else 'FAIL'}")
        if err > tol:
            # Retryable: report the cover this delta WOULD have, so a
            # round-1 deadlock can bootstrap round 2 (see below).
            q1_all = _desmear(pool1, pool_dt1, delta, period)
            dcov = nn_residual_distances(q1_all, aligned)
            covered = dcov <= max(0.6, 2.0 * _cluster_spacing(aligned))
            return None, (err, covered)
        # The MEASURED delta flows through selection/assignment; the
        # sub-resolution snap (see match_cluster_translations) is applied
        # at final assembly where the measured-track veto can see it.
        # Pool points this claim covers (its own de-smeared frame), for the
        # second round's bwd exclusion.
        dcov = nn_residual_distances(q1, aligned)
        covered = dcov <= max(0.6, 2.0 * _cluster_spacing(aligned))
        return (delta.astype(np.float32), res, res_raw, covered, err), False

    # NOTE a per-round RELATIVE error cut (keep hits within 1.5x of the
    # round's best) was tried here to kill marginally-verifying blends and
    # REVERTED: in a merged cluster the members' truths verify at different
    # errors (sparser member 0.72 vs denser 0.42 at 18k), so the global cut
    # dropped the sparser member's truth while the blend (0.59) survived —
    # and it changed nothing on the scene that motivated it. Blend killing
    # belongs to the selection/unique-support phase below.
    evaluated = []  # (delta, gated residuals, raw residuals, round2 flag)
    retry = []
    covered_union = np.zeros(len(pool1), bool)
    no_excl = np.zeros(len(pool1), bool)
    hits1 = []
    for cand in cands:
        hit, retryable = evaluate(cand, no_excl)
        if hit is not None:
            hits1.append(hit)
        elif retryable is not False:
            retry.append((retryable[0], retryable[1], cand))
    for hit in hits1:
        evaluated.append(hit[:3] + (False,))
        covered_union |= hit[3]
    # Round-1 DEADLOCK: a merged cluster whose members move in opposite
    # directions vetoes itself symmetrically — every member's truth fails
    # on the others' must-move strips and no accepted cover exists to relax
    # with (measured at 65.4k: both refined truths of a 2-member cluster at
    # err ~0.8 vs tol 0.51, zero claims). Bootstrap: provisionally take the
    # best-err failed candidate's cover as the exclusion seed. Junk cannot
    # ride this — every round-2 acceptance still verifies fwd + residual
    # must-move, and claims sit in the lowest tier.
    if retry and not evaluated:
        retry.sort(key=lambda t: t[0])
        covered_union |= retry[0][1]
        if debug:
            print(f"  [recover] deadlock bootstrap: seeding round 2 with "
                  f"err {retry[0][0]:.3f} candidate's cover")
    # SECOND round for bwd-failures: a merged sibling's claim fails round 1
    # on the FAST member's must-move strip (mutual veto); once the fast
    # member's claim is accepted, its covered pool points stop counting
    # against the sibling. Round-2 deltas enter SELECTION at the lowest
    # tier: with the accepted claims' cover excluded from bwd, ANY delta
    # with decent fwd verifies here (measured: a 2.14x smear alias laundered
    # through round 2 then stole a third of the object in reassignment) —
    # they may only explain points no round-1 delta can.
    if retry and covered_union.any():
        if debug:
            print(f"  [recover] round 2: {len(retry)} bwd-failures vs "
                  f"{int(covered_union.sum())} covered pool points")
        # Fixpoint iteration: acceptance grows the cover, which can unlock a
        # sibling evaluated earlier in the pass (measured: the bootstrap
        # seed's opposite-moving partner passed only AFTER the partner's own
        # acceptance excluded its strip — one fixed-order pass missed it).
        pending = list(retry)
        for _ in range(3):
            still = []
            hits2 = []
            for item in pending:
                # Exclude OTHER claims' covers only: a candidate whose own
                # round-1 cover is excluded loses exactly the evidence it
                # explains and can never pass (measured on the deadlock
                # bootstrap: the seed re-failed against itself at err 1.9).
                excl = covered_union & ~item[1]
                hit, _ = evaluate(item[2], excl)
                if hit is not None:
                    hits2.append(hit)
                else:
                    still.append(item)
            for hit in hits2:
                evaluated.append(hit[:3] + (True,))
                covered_union |= hit[3]
            pending = still
            if not hits2 or not pending:
                break

    # Delta SELECTION runs on the GATED residuals; point ASSIGNMENT on the
    # RAW ones. Selection by gated gain kills ghost deltas (their only
    # support is delta-insensitive pairs, which carry no delta evidence);
    # but a point whose matched pair is gated under the TRUE delta must
    # still be contested with its raw residual, or a spurious delta with a
    # finite marginal residual wins the argmin by default (measured: a
    # 0.94 m-off second delta claiming a third of a single object).
    #
    # CONFIRMED-track-consistent candidates claim before everything else
    # (velocity continuity is the only signal that separates convoy-aliased
    # swaps from true matches — both verify geometrically; unconfirmed
    # 1-frame-old tracks only SEED candidates, they don't outrank, so a
    # wrong scene-start match cannot self-perpetuate). Within a tier,
    # greedy max-GAIN (sum of ``r_in - residual`` over would-be claims)
    # with a tiny 0.05/m motion-magnitude tie-break toward the physically
    # nearer explanation. (An exact facility-location set selection was
    # tried here and measured WORSE: on smeared objects alias deltas fit
    # interior points at noise level, so set costs cannot separate blends
    # from true pairs any better than the greedy while losing the
    # unique-support guard's crispness.)
    def _track_consistent(delta):
        return any(
            conf and float(np.linalg.norm(delta - np.asarray(td))) <= 0.6
            for td, conf in track_deltas
        )

    def _tier(delta, round2):
        # 0 = confirmed-track-consistent, 1 = round-1 geometric,
        # 2 = round-2 (cover-relaxed verification; lowest precedence).
        if _track_consistent(delta):
            return 0
        return 2 if round2 else 1

    out = []  # (delta, claim, gated res, raw res, tier)
    unassigned = np.ones(len(pts0), bool)
    # Best raw residual under any ACCEPTED delta so far: each additional
    # delta must have UNIQUE SUPPORT — >= min_points whose accepted
    # explanation clearly fails (raw residual > 1.5 x the claim radius).
    # On an extended smeared object a delta wrong by ``e`` is point-wise
    # unfalsifiable (every interior point matches a surface spot offset by
    # ``e`` at ~sampling noise; measured claims spanning the full dt
    # range), so it would otherwise ride the accepted delta's residual
    # noise tail into acceptance and steal ~30% of the object in the
    # argmin. Only the ``|e|``-wide EDGE strip falsifies it — and that is
    # exactly what unique support measures: a real second object in a
    # merged cluster has hundreds of unexplained points, a smear alias has
    # none.
    prev_best = np.full(len(pts0), np.inf, np.float32)
    for tier_now in (0, 1, 2):
        pool = [
            e[:3] for e in evaluated if _tier(e[0], e[3]) == tier_now
        ]
        while pool:
            best_gain, best_ix = -np.inf, -1
            for ix, (delta, res, res_raw) in enumerate(pool):
                claim = (res <= r_in) & unassigned
                unique = claim & (prev_best > 1.5 * r_in)
                if unique.sum() < min_points:
                    continue
                gain = float((r_in - res[claim]).sum())
                gain -= 0.05 * float(np.linalg.norm(delta))
                if gain > best_gain:
                    best_gain, best_ix = gain, ix
            if best_ix < 0:
                if debug and pool:
                    print(f"  [recover] selection: {len(pool)} evaluated "
                          "deltas left without unique support")
                break
            delta, res, res_raw = pool.pop(best_ix)
            claim = (res_raw <= r_in) & unassigned
            out.append((delta, claim, res, res_raw, tier_now))
            unassigned &= ~claim
            prev_best = np.minimum(prev_best, res_raw)
    if len(out) > 1:
        # Point-level reassignment. Claim ORDER grabs marginal points of a
        # neighboring merged object before that object's own delta gets its
        # turn, so each claimed point is re-contested:
        # - TIER precedence survives: a point any CONFIRMED-track delta can
        #   claim is contested only among confirmed deltas — convoy
        #   aliasing lets an unconfirmed delta align a cross-object smear
        #   slice at genuinely lower residual, and only velocity continuity
        #   overrules that.
        # - UNAMBIGUOUS points (one candidate, or the best raw residual
        #   leads the runner-up by >= 0.15 m) go to their argmin delta.
        # - AMBIGUOUS points — near-ties, including delta-insensitive
        #   pairs whose residual is ~0 under every delta — go to the owner
        #   whose DE-SMEARED space places them nearest that owner's
        #   unambiguous body: the true owner's de-smear collapses its
        #   object to a compact rigid shape that contains the point, while
        #   a wrong owner's leaves it away from its body (raw argmin on
        #   crossing smears misassigned 9-21% of two merged objects'
        #   points; body proximity resolves them).
        # Entries that shrink below ``min_points`` fall away.
        all_raw = np.stack([rr for _, _, _, rr, _ in out])  # (n_del, n_pts)
        all_gated = np.stack([r for _, _, r, _, _ in out])
        claimed = np.stack([c for _, c, _, _, _ in out]).any(0)
        claimable = all_raw <= r_in
        # Tier precedence generalizes the confirmed-first rule: a point any
        # lower-numbered tier can claim is contested only within that tier
        # (confirmed > round-1 geometric > round-2 cover-relaxed) — EXCEPT
        # on a decisive residual win (<= 0.5x the best higher-tier row):
        # near-ties are exactly the alias slices tiering exists to settle
        # (both residuals ~noise), but a merged sibling's tier-1 delta
        # holds a fast member's points only as MARGINAL alias pairs
        # (0.2-0.45 m) while the member's round-2 truth fits them at
        # sampling noise (measured: 231 of 659 points stolen at f1 of the
        # 65k suite without the decisive-win exception).
        tiers = np.asarray([e[4] for e in out])  # (n_del,)
        tier_col = np.where(claimable, tiers[:, None], np.iinfo(np.int64).max)
        min_tier = tier_col.min(0)  # (n_pts,)
        top_raw = np.where(
            claimable & (tiers[:, None] == min_tier[None, :]), all_raw, np.inf
        ).min(0)
        claimable = claimable & (
            (tiers[:, None] == min_tier[None, :])
            | (all_raw <= 0.5 * top_raw[None, :])
        )
        raw_masked = np.where(claimable, all_raw, np.inf)
        order = np.argsort(raw_masked, axis=0)
        best = order[0]
        best_r = np.take_along_axis(raw_masked, best[None], 0)[0]
        second_r = (
            np.take_along_axis(raw_masked, order[1][None], 0)[0]
            if len(out) > 1 else np.full(len(pts0), np.inf)
        )
        n_cand = claimable.sum(0)
        # n_cand >= 2 guarantees a finite runner-up; elsewhere inf - inf
        # is irrelevant (masked out) — just silence it.
        with np.errstate(invalid="ignore"):
            margin = second_r - best_r
        ambiguous = claimed & (n_cand >= 2) & (margin < 0.15)
        owners = np.where(claimed & ~ambiguous & (n_cand >= 1), best, -1)
        amb_ix = np.flatnonzero(ambiguous)
        if len(amb_ix):
            bf_dist = np.full((len(out), len(amb_ix)), np.inf, np.float32)
            for k, (delta, _, _, _, _) in enumerate(out):
                body_m = (owners == k) & np.isfinite(all_gated[k])
                if body_m.sum() < 3:
                    continue
                idt_b = None if dt0 is None else dt0[body_m]
                idt_q = None if dt0 is None else dt0[amb_ix]
                body = _desmear(pts0[body_m], idt_b, delta, period)
                q = _desmear(pts0[amb_ix], idt_q, delta, period)
                d_k, _ = _nn_query_fn(body)(q)
                bf_dist[k] = np.where(claimable[k][amb_ix], d_k, np.inf)
            has_body = np.isfinite(bf_dist).any(0)
            owners[amb_ix[has_body]] = np.argmin(bf_dist, axis=0)[has_body]
            # Ambiguous points with no resolvable body fall back to argmin.
            rest = amb_ix[~has_body]
            owners[rest] = best[rest]
        reassigned = []
        for k, (delta, _, res, res_raw, tier_k) in enumerate(out):
            mask = owners == k
            if mask.sum() >= min_points:
                reassigned.append((delta, mask, res, res_raw, tier_k))
        if reassigned:
            out = reassigned
    # Sub-resolution snap, applied at assembly: a verified delta below the
    # shared acceptance tolerance carries no single-frame motion evidence —
    # emit it as zero so sparse static structure cannot acquire spurious
    # sub-tolerance priors (measured: test_matcher_stress stopped-object
    # case) — UNLESS a measured-confirmed track agrees with it (a real slow
    # mover; see measured_track_consistent). ``measured_out`` receives the
    # pre-snap deltas in claim order so the caller's tracker can accumulate
    # measured-motion evidence across frames either way.
    final = []
    for delta, claim, _, _, _ in out:
        d_out = delta
        if float(np.linalg.norm(delta)) < tol_shared and not (
            track_meas
            and claim.any()
            and measured_track_consistent(delta, pts0[claim].mean(0), track_meas)
        ):
            d_out = np.zeros(3, np.float32)
        if measured_out is not None:
            measured_out.append(np.asarray(delta, np.float32))
        final.append((d_out, claim))
    return final


def match_cluster_translations(
    pc0: np.ndarray,
    labels0: np.ndarray,
    pc1: np.ndarray,
    labels1: np.ndarray,
    max_clusters: int,
    match_gate: float,
    verify_tol: float = 0.45,
    spacing_factor: float = 1.75,
    dt0=None,
    dt1=None,
    period: float = 0.1,
    recover_dynamic1=None,
    recover_cand1=None,
    return_splits: bool = False,
    trim: float = 1.0,
    track_priors=None,
    track_meas=None,
    measured_out=None,
    eligible0=None,
):
    """Translation seeds from VERIFIED 1-1 cluster matching.

    ``track_meas`` (ClusterTracker.predict_measured output) lets a
    measured-confirmed slow mover's sub-tolerance delta survive the
    sub-resolution snap; ``measured_out`` (a dict, if given) receives the
    PRE-snap measured deltas — keyed ``i`` for cluster i's 1-1 match and
    ``(i, k)`` for its k-th split claim — so the caller's tracker can
    accumulate measured-motion evidence across frames.

    For every (pc0 cluster, pc1 cluster) pair whose centroids lie within
    ``match_gate`` meters, the candidate delta (centroid difference, refined
    by trimmed translation-ICP) is verified by aligning the clusters and
    scoring the TWO-SIDED mean NN residual — the max of (shifted pc0 -> pc1)
    and (pc1 -> shifted pc0) mean distances. One-sided medians cannot tell
    two same-model vehicles apart (measured on the benchmark: a wrong car-to-
    car match scored median 0.30 while its two-sided mean was 1.25 vs ~0.25
    for every true pair — full-coverage residuals expose the differing
    rolling-shutter smears). The acceptance tolerance is DENSITY-AWARE:
    ``max(verify_tol, spacing_factor * median intra-cluster NN spacing)`` —
    a correct alignment can never score below the cluster's own sampling
    granularity, so sparse clusters at range keep their (true) matches while
    dense wrong-object pairs stay rejected. Pairs are accepted greedily by
    ascending error, each side used once. This is the fast-object
    initialization role of ICP-Flow's histogram translation search — objects
    moving beyond the ICP correspondence gate start inside it.

    When per-point sweep times are given (``dt0``/``dt1``, seconds from
    sweep start; ``period`` = inter-sweep time) both sides are de-smeared
    with the candidate delta inside the refine/verify loop — see
    :func:`_desmear`.

    ``recover_dynamic1`` (optional bool mask over pc1) enables a second
    stage for pc0 clusters the 1-1 matching left unmatched — see
    :func:`recover_split_translations`. With ``return_splits=True`` a third
    output maps cluster index -> the recovered ``(delta, local_mask)`` list,
    so a merged multi-object cluster can carry per-point priors instead of
    one average delta.

    Returns ((max_clusters, 3) float32 seeds, (max_clusters,) bool matched)
    [, splits dict].
    """
    init_t = np.zeros((max_clusters, 3), np.float32)
    matched = np.zeros(max_clusters, bool)
    splits = {}
    n0 = int(labels0.max())
    n1 = int(labels1.max())
    if n0 == 0:
        return (init_t, matched, splits) if return_splits else (init_t, matched)
    idx0 = [np.flatnonzero(labels0 == c) for c in range(1, n0 + 1)]
    pts0 = [pc0[ix] for ix in idx0]
    dts0 = [None if dt0 is None else np.asarray(dt0)[ix] for ix in idx0]
    cents0 = np.stack([p.mean(0) for p in pts0])

    def tracks_near(i):
        """(delta, confirmed) of tracks (ClusterTracker.predict output)
        whose predicted position falls on cluster i — distance to the
        cluster's POINTS, not its centroid: a density-adaptively merged
        multi-object cluster has its centroid between the members, farther
        from each track than any gate that would still reject neighboring
        objects' tracks."""
        if not track_priors:
            return []
        return [
            (d, conf)
            for p, d, conf in track_priors
            if float(
                np.linalg.norm(pts0[i][:, :3] - p[None, :3], axis=1).min()
            )
            <= 1.5
        ]

    used0 = set()
    used_pairs = {}  # accepted 1-1 matches: pc0 cluster index -> pc1 index
    if n1 > 0:
        idx1 = [np.flatnonzero(labels1 == c) for c in range(1, n1 + 1)]
        pts1 = [pc1[ix] for ix in idx1]
        dts1 = [None if dt1 is None else np.asarray(dt1)[ix] for ix in idx1]
        cents1 = np.stack([p.mean(0) for p in pts1])
        d = np.linalg.norm(cents0[:, None] - cents1[None, :], axis=-1)

        spacing1 = [_cluster_spacing(p) for p in pts1]

        candidates = []  # (alignment_error, i, j, delta)
        for i in range(n0):
            if len(pts0[i]) < 8:
                continue  # tiny fragments align anywhere — recovery instead
            for j in range(n1):
                if d[i, j] > match_gate or len(pts1[j]) < 8:
                    continue
                # Raw centroid deltas are biased by ~1 m when the two
                # frames' clusters cover different subsets of the object
                # (partial clustering of rolling-shutter smears — measured
                # on the 25 m/s benchmark bucket); trimmed translation-only
                # ICP removes it.
                delta = _refine_translation(
                    pts0[i], pts1[j], cents1[j] - cents0[i],
                    dt0=dts0[i], dt1=dts1[j], period=period,
                )
                err = _pair_alignment_error(
                    pts0[i], pts1[j], delta,
                    dt0=dts0[i], dt1=dts1[j], period=period, trim=trim,
                )
                tol = min(max(verify_tol, spacing_factor * spacing1[j]), 1.0)
                if err <= tol:
                    # The MEASURED delta rides into assignment; the
                    # sub-resolution snap is applied post-assignment where
                    # the measured-track veto can see it (below).
                    candidates.append((err, i, j, delta, tol))
        # GLOBAL min-cost assignment over the verified candidate graph.
        # Cost = err + a 0.05/m motion-magnitude penalty; two identical
        # vehicles in convoy are geometrically interchangeable (same shape,
        # same velocity -> same smear), and the old greedy accept could
        # cross-match them on residual noise (measured 3.4-4.2 m swapped
        # deltas). The swap is globally inconsistent: shifting the whole
        # chain by one leaves the last vehicle unmatched, so a
        # maximum-matching assignment (any real cost << NO_MATCH) prefers
        # the identity mapping structurally — including at SCENE STARTS
        # where no track exists yet. CONFIRMED-track-consistent pairs get a
        # large discount (velocity continuity outranks geometry; 1-frame-old
        # unconfirmed tracks deliberately don't).
        used1 = set()
        if candidates:
            NO_MATCH = 1.0e6
            cost = np.full((n0, n1), NO_MATCH, np.float64)
            by_pair = {}
            for err, i, j, delta, tol in candidates:
                # Motion-magnitude penalty on the POST-snap magnitude (a
                # sub-tolerance candidate competes as "did not move").
                eff = delta if float(np.linalg.norm(delta)) >= tol else 0.0
                consistent = any(
                    conf and float(np.linalg.norm(delta - td)) <= 0.6
                    for td, conf in tracks_near(i)
                )
                c_ = err + 0.05 * float(np.linalg.norm(eff))
                if consistent:
                    c_ -= 100.0
                if c_ < cost[i, j]:
                    cost[i, j] = c_
                    by_pair[(i, j)] = (delta, tol)
            from scipy.optimize import linear_sum_assignment

            rows, cols = linear_sum_assignment(cost)
            for i, j in zip(rows, cols):
                if cost[i, j] >= NO_MATCH:
                    continue
                used0.add(i)
                used1.add(j)
                if i < max_clusters:
                    delta, tol = by_pair[(i, j)]
                    if measured_out is not None:
                        measured_out[i] = np.asarray(delta, np.float32)
                    # SUB-RESOLUTION SNAP: a delta smaller than the pair's
                    # own acceptance tolerance is below the measurement's
                    # noise floor — indistinguishable from "did not move".
                    # Sparse (0.4 m-spaced) STATIC objects re-sampled by
                    # successive sweeps otherwise verify spurious ~0.6 m
                    # deltas inside their ~0.7 m tolerance (measured:
                    # test_matcher_stress stopped-object case). The match
                    # itself stays (tracking + pc1 exclusivity); only the
                    # motion claim zeroes — UNLESS a measured-confirmed
                    # track agrees (a real slow mover; see
                    # measured_track_consistent).
                    if float(np.linalg.norm(delta)) < tol and not (
                        track_meas
                        and measured_track_consistent(
                            delta, cents0[i], track_meas
                        )
                    ):
                        delta = np.zeros(3, np.float32)
                    init_t[i] = delta
                    matched[i] = True
                    used_pairs[i] = j

    if recover_dynamic1 is not None:
        dyn_ix = np.flatnonzero(np.asarray(recover_dynamic1, bool))
        dyn1 = pc1[dyn_ix, :3]
        dyn_dt1 = None if dt1 is None else np.asarray(dt1)[dyn_ix]
        # pc1-side exclusivity: dynamic points already explained by an
        # accepted match leave the recovery pool, so a cluster whose true
        # target vanished (occlusion / field-of-view exit) cannot latch onto
        # a NEIGHBOR object's points — measured err 3-5 m matches before
        # this gate existed. Seeded below with the 1-1 matches' COVER (the
        # aligned source within a cover radius), NOT whole target clusters:
        # a merged pc1 cluster is only partially explained by its 1-1 match,
        # and removing all of it locks the unexplained member's points away
        # from every other cluster's recovery (measured at 18.4k: a merged
        # pc0 pair's 34 m/s member uncovered because its target points sat
        # in a pc1 cluster another object's 1-1 match had "used").
        pool_used = np.zeros(len(dyn_ix), bool)

        def _mark_covered(aligned_pts, q_delta):
            """Pool points within cover radius of the aligned cluster."""
            if len(dyn_ix) == 0 or len(aligned_pts) == 0:
                return
            from himo_tpu.training.ssl_labels import nn_residual_distances

            q1_all = _desmear(dyn1, dyn_dt1, q_delta, period)
            d = nn_residual_distances(q1_all, aligned_pts)
            r_cover = max(0.6, 2.0 * _cluster_spacing(aligned_pts))
            pool_used[d <= r_cover] = True

        for i, j in used_pairs.items():
            src = pc0[labels0 == i + 1]
            sdt = None if dt0 is None else np.asarray(dt0)[labels0 == i + 1]
            _mark_covered(
                _desmear(src, sdt, init_t[i], period) + init_t[i], init_t[i]
            )

        # EVERY cluster goes through per-point inlier gating, matched ones
        # included: a density-adaptively merged two-object cluster can pass
        # the 1-1 verification on its dominant member, and only the inlier
        # gate stops its delta being painted over the second object. The 1-1
        # delta rides along as the first candidate so a clean match keeps
        # its (windowed-verified) seed. Largest clusters claim pool first
        # (labels are compacted largest-first).
        for i in range(min(n0, max_clusters)):
            if len(pts0[i]) < 8 or len(dyn_ix) == 0:
                continue
            rad0 = float(
                np.linalg.norm(pts0[i][:, :3] - cents0[i][None, :3], axis=1).max()
            )
            near = np.linalg.norm(
                dyn1[:, :2] - cents0[i][None, :2], axis=1
            ) <= (match_gate + rad0 + 1.0)
            if i in used_pairs:
                # Re-admit this cluster's own 1-1 target (it is "used" by
                # the cluster itself).
                near &= (~pool_used) | (labels1[dyn_ix] == used_pairs[i] + 1)
            else:
                near &= ~pool_used
            found = recover_split_translations(
                pts0[i],
                dyn1[near],
                match_gate,
                verify_tol=verify_tol,
                spacing_factor=spacing_factor,
                dt0=dts0[i],
                pool_dt1=None if dyn_dt1 is None else dyn_dt1[near],
                period=period,
                extra_candidates=[init_t[i]] if matched[i] else [],
                trim=trim,
                track_deltas=tracks_near(i),
                track_meas=track_meas or (),
                measured_out=(
                    None if measured_out is None else (split_meas := [])
                ),
                pool_labels=labels1[dyn_ix][near],
                cand_mask=(
                    None if recover_cand1 is None
                    else np.asarray(recover_cand1, bool)[dyn_ix][near]
                ),
                # Zero-explanation reference: the cluster's hop-CONNECTED
                # completed body (its under-threshold interior included),
                # nothing more. Both wider choices were measured worse: the
                # full local pc0 blankets the scene at production density
                # (~0.4 m background spacing < the 0.45 m radius) and
                # zero-explains every fast strip, and even background-only
                # inclusion kills true 34 m/s claims whose landing zone has
                # scatter; while the bare cluster misses a slow object's
                # unflagged interior and shelters fabricated large deltas
                # (sparse slow-mover stress scene).
                zero_ref=_connected_body(pc0, labels0, i + 1, eligible0),
            )
            if found:
                init_t[i] = found[0][0]  # largest split seeds the cluster
                matched[i] = True
                splits[i] = found
                if measured_out is not None:
                    for k, meas in enumerate(split_meas):
                        measured_out[(i, k)] = meas
                for delta, local_mask in found:
                    ldt = None if dts0[i] is None else dts0[i][local_mask]
                    _mark_covered(
                        _desmear(pts0[i][local_mask], ldt, delta, period)
                        + delta,
                        delta,
                    )
            # A 1-1 matched cluster whose windowed re-verification found
            # nothing keeps its cluster-level match (splits entry absent).
    if return_splits:
        return init_t, matched, splits
    return init_t, matched


def icpflow_estimate(
    pc0: np.ndarray,
    pc1: np.ndarray,
    valid0: np.ndarray,
    valid1: np.ndarray,
    config: ICPFlowConfig = ICPFlowConfig(),
    dt0=None,
    dt1=None,
    tracker=None,
    pose1=None,
):
    """Full ICP-Flow: host clustering + device batched registration.

    pc0 must already be ego-compensated into the pc1 frame; the returned
    residual flow is zero on static/unclustered points. Optional sweep
    times (``dt0``/``dt1``) give the translation matcher its de-smeared
    form; a per-scene :class:`ClusterTracker` (+``pose1``) adds velocity
    continuity to the seeds.
    """
    from himo_tpu.training.ssl_labels import cluster_dynamic_points, dynamic_mask_from_nn

    pc0 = np.asarray(pc0[:, :3], np.float32)
    pc1 = np.asarray(pc1[:, :3], np.float32)
    valid0 = np.asarray(valid0, bool)
    valid1 = np.asarray(valid1, bool)

    dynamic = np.zeros(len(pc0), bool)
    dynamic[valid0] = dynamic_mask_from_nn(
        pc0[valid0], pc1[valid1], config.dynamic_threshold
    )
    labels = cluster_dynamic_points(
        pc0,
        dynamic,
        eps=config.dbscan_eps,
        min_samples=config.dbscan_min_samples,
        max_clusters=config.max_clusters,
    )

    flow = np.zeros_like(pc0)
    n_clusters = int(labels.max())
    if n_clusters == 0:
        return flow, 0.0

    # pc1's dynamic clusters give the translation seeds (fast-object init).
    dynamic1 = np.zeros(len(pc1), bool)
    dynamic1[valid1] = dynamic_mask_from_nn(
        pc1[valid1], pc0[valid0], config.dynamic_threshold
    )
    labels1 = cluster_dynamic_points(
        pc1,
        dynamic1,
        eps=config.dbscan_eps,
        min_samples=config.dbscan_min_samples,
        max_clusters=config.max_clusters,
    )
    track_priors = None
    if tracker is not None and pose1 is not None:
        track_priors = tracker.predict(pose1)
    init_t, matched = match_cluster_translations(
        pc0, labels, pc1, labels1, config.max_clusters, config.match_gate,
        dt0=dt0, dt1=dt1, recover_dynamic1=dynamic1,
        track_priors=track_priors,
    )
    if tracker is not None and pose1 is not None:
        assigned = [
            (pc0[labels == cid + 1].mean(0), init_t[cid])
            for cid in range(min(int(labels.max()), config.max_clusters))
            if matched[cid]
        ]
        tracker.update(assigned, pose1)

    c, k = config.max_clusters, config.cluster_capacity
    clusters = np.zeros((c, k, 3), np.float32)
    cluster_valid = np.zeros((c, k), bool)
    point_slots = {}
    overflow = {}  # cid -> ALL point indices (rigid-transform recipients)
    for cid in range(1, n_clusters + 1):
        idx_full = np.where(labels == cid)[0]
        if len(idx_full) > k:
            # Strided subsample into the registration slots (first-k is
            # scan-order biased toward one side of the object); the
            # cluster's rigid transform covers every point afterwards.
            idx = idx_full[np.linspace(0, len(idx_full) - 1, k).astype(int)]
            overflow[cid] = idx_full
        else:
            idx = idx_full
        clusters[cid - 1, : len(idx)] = pc0[idx]
        cluster_valid[cid - 1, : len(idx)] = True
        point_slots[cid] = idx

    cluster_flow, rots, ts = (
        np.asarray(a)
        for a in icp_register_clusters(
            clusters, cluster_valid, pc1, valid1, config, jnp.asarray(init_t)
        )
    )
    for cid, idx in point_slots.items():
        flow[idx] = cluster_flow[cid - 1, : len(idx)]
    for cid, idx_full in overflow.items():
        pts = pc0[idx_full]
        flow[idx_full] = pts @ rots[cid - 1].T + ts[cid - 1] - pts
    return flow, 0.0


@register_estimator("icpflow")
def make_icpflow(**overrides):
    config = ICPFlowConfig(**overrides)
    trackers = {}  # per-scene velocity continuity (runner feeds frames in order)

    def estimate(pc0, pc1, valid0, valid1, key=None, dt0=None, dt1=None,
                 scene_id=None, pose1=None):
        tracker = None
        if scene_id is not None and pose1 is not None:
            tracker = trackers.setdefault(scene_id, ClusterTracker())
        return icpflow_estimate(
            pc0, pc1, valid0, valid1, config,
            dt0=dt0, dt1=dt1, tracker=tracker, pose1=pose1,
        )

    estimate.trackers = trackers  # models/runner.py's scene-start repair
    return estimate
