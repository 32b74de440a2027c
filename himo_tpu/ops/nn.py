"""On-device nearest-neighbor distances & Chamfer losses.

The reference's training/optimization losses need NN distances between
~100k-point clouds; its eval uses host cKDTrees (eval.py:50-62) and the CUDA
submodule for training. Here one search serves every entry point
(``nn_distance_sq``, ``nn_argmin``, ``fused_masked_nn``):

- the squared distance is taken in difference form ``sum_k (q_k - r_k)^2``:
  three multiply-adds per pair in exact float32 (the ``|q|^2+|r|^2-2q.r``
  expansion cancels catastrophically at LiDAR coordinates, and with three
  coordinates there is no matrix-unit work to gain from it);
- queries are processed in chunks sized so one chunk spans at most
  ``_PAIR_BUDGET`` (query, reference) pairs; within a chunk XLA fuses the
  broadcast-subtract-square-min into one reduction, so the (N, M) distance
  matrix is never stored.

Masking: invalid references are moved to ``SENTINEL`` (1e6 m away) or carry
an additive penalty, so they lose every min race; invalid queries are
zeroed by the helpers here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SENTINEL = 1.0e6  # coordinates of masked rows; ~1e12 squared distance
_MASK_BIG = 1.0e14  # additive penalty; SENTINEL^2 distances are ~1e12
_PAIR_BUDGET = 1 << 26  # (query, ref) pairs per chunk


def _chunk_rows(n: int, m: int) -> int:
    """Power-of-two query chunk with chunk * m <= _PAIR_BUDGET (>= 1)."""
    c = max(1, _PAIR_BUDGET // max(m, 1))
    c = 1 << (c.bit_length() - 1)
    return min(c, max(1, 1 << (n - 1).bit_length()))


def _sq_dist(qc: jax.Array, rt: jax.Array) -> jax.Array:
    """(C, 3) queries x (3, M) references -> (C, M) squared distances."""
    d2 = (qc[:, 0:1] - rt[0]) ** 2
    d2 = d2 + (qc[:, 1:2] - rt[1]) ** 2
    return d2 + (qc[:, 2:3] - rt[2]) ** 2


def _by_query_chunk(fn, q3: jax.Array, pairs_per_query: int, axis: int):
    """``fn`` over query chunks of at most ``_PAIR_BUDGET`` pairs; each
    output leaf is joined along its query ``axis`` and cut to N rows."""
    n = q3.shape[0]
    chunk = _chunk_rows(n, pairs_per_query)
    if chunk >= n:
        return fn(q3)
    qp = jnp.pad(q3, ((0, -n % chunk), (0, 0)))
    out = jax.lax.map(fn, qp.reshape(-1, chunk, 3))

    def join(x):  # (chunks, ..., C, ...) -> (..., chunks * C, ...)
        x = jnp.moveaxis(x, 0, axis)
        x = x.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 2:])
        return jax.lax.slice_in_dim(x, 0, n, axis=axis)

    return jax.tree.map(join, out)


def _min_argmin(d: jax.Array):
    """(min, first argmin) over the last axis in one variadic reduction."""
    iota = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)

    def pick(a, b):
        (av, ai), (bv, bi) = a, b
        take_b = (bv < av) | ((bv == av) & (bi < ai))
        return jnp.where(take_b, bv, av), jnp.where(take_b, bi, ai)

    return jax.lax.reduce(
        (d, iota),
        (jnp.array(jnp.inf, d.dtype), jnp.array(jnp.iinfo(jnp.int32).max, jnp.int32)),
        pick,
        (d.ndim - 1,),
    )


def nn_search(q3: jax.Array, r3: jax.Array, penalties: jax.Array | None = None):
    """Nearest reference per query, for each additive penalty row.

    Args:
        q3: (N, 3) float32 queries.
        r3: (M, 3) float32 references.
        penalties: optional (P, M) additive per-reference penalties; row p
            gives the p-th search (0 = live, ``_MASK_BIG`` = masked).

    Returns:
        (P, N) float32 ``min_r |q - r|^2 + penalty[p, r]`` and (P, N) int32
        first argmins (P = 1 without penalties).
    """
    rt = r3.astype(jnp.float32).T  # (3, M): each coordinate contiguous
    pens = None if penalties is None else penalties.astype(jnp.float32)
    p = 1 if pens is None else pens.shape[0]

    def one(qc):  # (C, 3) -> (P, C), (P, C)
        d2 = _sq_dist(qc, rt)[None]
        return _min_argmin(d2 if pens is None else d2 + pens[:, None, :])

    return _by_query_chunk(one, q3.astype(jnp.float32), rt.shape[1] * p, axis=1)


def _masked(pts: jax.Array, valid: jax.Array | None) -> jax.Array:
    pts = pts[:, :3]
    return pts if valid is None else jnp.where(valid[:, None], pts, SENTINEL)


def nn_argmin(
    query: jax.Array,
    ref: jax.Array,
    query_valid: jax.Array | None = None,
    ref_valid: jax.Array | None = None,
):
    """(min squared distance, index of nearest reference point) per query.

    Invalid refs never win the min race; invalid queries return (0, 0)."""
    d2, idx = nn_search(_masked(query, query_valid), _masked(ref, ref_valid))
    d2, idx = d2[0], idx[0]
    if query_valid is not None:
        d2 = jnp.where(query_valid, d2, 0.0)
        idx = jnp.where(query_valid, idx, 0)
    return d2, idx


@jax.custom_vjp
def _nn_core(q3: jax.Array, r3: jax.Array) -> jax.Array:
    """Min squared distance per query, differentiable in both clouds.

    The gradient is analytic at the argmin: d/dq |q - r*|^2 = 2 (q - r*),
    and refs accumulate the negatives via a segment sum — an O(N) backward
    instead of replaying the search."""
    return nn_search(q3, r3)[0][0]


def _nn_core_fwd(q3, r3):
    d2, idx = nn_search(q3, r3)
    return d2[0], (q3, r3, idx[0])


def _nn_core_bwd(residuals, g):
    q3, r3, idx = residuals
    dq = 2.0 * g[:, None] * (q3 - r3[idx])
    dr = -jax.ops.segment_sum(dq, idx, num_segments=r3.shape[0])
    return dq.astype(q3.dtype), dr.astype(r3.dtype)


_nn_core.defvjp(_nn_core_fwd, _nn_core_bwd)


def nn_distance_sq(
    query: jax.Array,
    ref: jax.Array,
    query_valid: jax.Array | None = None,
    ref_valid: jax.Array | None = None,
) -> jax.Array:
    """Per-query squared distance to the nearest reference point.

    Differentiable in both clouds (custom VJP through the argmin). Masks are
    applied OUTSIDE the custom core by moving invalid points to the sentinel
    — ``where`` blocks their gradients.

    Args:
        query: (N, >=3) points.
        ref: (M, >=3) points.
        query_valid / ref_valid: optional masks; invalid refs never win,
            invalid queries return 0.

    Returns:
        (N,) float32 min squared distances (0 for invalid queries).
    """
    d2 = _nn_core(_masked(query, query_valid), _masked(ref, ref_valid))
    if query_valid is not None:
        d2 = jnp.where(query_valid, d2, 0.0)
    return d2


def _masked_mean(d, valid):
    if valid is None:
        return jnp.mean(d)
    return jnp.sum(jnp.where(valid, d, 0.0)) / jnp.maximum(
        jnp.sum(valid.astype(d.dtype)), 1.0
    )


def chamfer_distance(
    pc1: jax.Array,
    pc2: jax.Array,
    valid1: jax.Array | None = None,
    valid2: jax.Array | None = None,
) -> jax.Array:
    """Symmetric mean-NN Chamfer, matching the eval definition
    (mean of both directions' mean NN distance, NOT squared)."""
    d12 = jnp.sqrt(nn_distance_sq(pc1, pc2, valid1, valid2))
    d21 = jnp.sqrt(nn_distance_sq(pc2, pc1, valid2, valid1))
    return 0.5 * (_masked_mean(d12, valid1) + _masked_mean(d21, valid2))


def truncated_chamfer(
    pc1: jax.Array,
    pc2: jax.Array,
    valid1: jax.Array | None = None,
    valid2: jax.Array | None = None,
    max_dist: float = 2.0,
) -> jax.Array:
    """Truncated symmetric Chamfer on SQUARED distances — the classic scene
    flow optimization loss (distances beyond ``max_dist`` are clipped so
    outliers and occlusions don't dominate)."""
    cap = max_dist * max_dist
    d12 = jnp.minimum(nn_distance_sq(pc1, pc2, valid1, valid2), cap)
    d21 = jnp.minimum(nn_distance_sq(pc2, pc1, valid2, valid1), cap)
    return _masked_mean(d12, valid1) + _masked_mean(d21, valid2)


# ---------------------------------------------------------------------------
# Fused SSL-chamfer mins: the seflowpp loss needs FOUR NN sweeps over the
# same (warped pc0, pc1) pair — {all, dynamic-only} masks x {q->r, r->q}
# directions. Each direction computes its distances once and folds both
# masks as additive penalties.


def _fused_search(q3, r3, qa, qd, ra, rd):
    (dqa, dqd), (iqa, iqd) = nn_search(q3, r3, jnp.stack([ra, rd]))
    (dra, drd), (ira, ird) = nn_search(r3, q3, jnp.stack([qa, qd]))
    return (dqa, dqd, dra, drd), (iqa, iqd, ira, ird)


@jax.custom_vjp
def fused_masked_nn(q3, r3, qa, qd, ra, rd):
    """Four masked NN sweeps, two distance computations.

    Args:
        q3 / r3: (N, 3) / (M, 3) clouds.
        qa / qd: (N,) float additive penalties (0 = live, _MASK_BIG = masked)
            applied to queries WHEN THEY ACT AS REFERENCES (r->q direction).
        ra / rd: (M,) penalties on the references (q->r direction).

    Returns:
        (dq_all, dq_dyn, dr_all, dr_dyn) squared NN distances. Rows whose
        own side is masked are garbage — exclude them in the reduction.
        Differentiable in q3/r3 (analytic VJP at the argmin).
    """
    return _fused_search(q3, r3, qa, qd, ra, rd)[0]


def _fused_fwd(q3, r3, qa, qd, ra, rd):
    dists, idxs = _fused_search(q3, r3, qa, qd, ra, rd)
    return dists, (q3, r3, qa, ra) + idxs


def _fused_bwd(residuals, g):
    q3, r3, qa, ra, iqa, iqd, ira, ird = residuals
    g_qa, g_qd, g_ra, g_rd = g
    nq, nr = q3.shape[0], r3.shape[0]

    def diffs(gv, src, dst_pts, idx):
        return 2.0 * gv[:, None] * (src - dst_pts[idx])

    dq_a = diffs(g_qa, q3, r3, iqa)
    dq_d = diffs(g_qd, q3, r3, iqd)
    dr_a = diffs(g_ra, r3, q3, ira)
    dr_d = diffs(g_rd, r3, q3, ird)
    # One scatter per destination: concatenated sources, shared segments.
    dr_scatter = jax.ops.segment_sum(
        jnp.concatenate([dq_a, dq_d]), jnp.concatenate([iqa, iqd]), num_segments=nr
    )
    dq_scatter = jax.ops.segment_sum(
        jnp.concatenate([dr_a, dr_d]), jnp.concatenate([ira, ird]), num_segments=nq
    )
    dq = dq_a + dq_d - dq_scatter
    dr = dr_a + dr_d - dr_scatter
    # Cotangents carry the primal dtypes (penalties are float64 under x64).
    zq, zr = jnp.zeros_like(qa), jnp.zeros_like(ra)
    return dq.astype(q3.dtype), dr.astype(r3.dtype), zq, zq, zr, zr


fused_masked_nn.defvjp(_fused_fwd, _fused_bwd)


def fused_chamfer_terms(
    warped: jax.Array,
    pc1: jax.Array,
    valid0: jax.Array,
    valid1: jax.Array,
    dynamic0: jax.Array,
    dynamic1: jax.Array,
    max_dist: float = 2.0,
    dynamic_max_dist: float | None = None,
):
    """(truncated chamfer over all valid points, truncated chamfer over the
    SSL-dynamic subsets) — both terms from one fused NN pass per direction.

    ``dynamic_max_dist`` optionally widens the dynamic term's truncation
    radius (default: same as ``max_dist``). Objects at 25-34 m/s move
    2.5-3.4 m between sweeps — beyond the classic 2 m radius every gradient
    is clipped away; the dynamic-only term is restricted to SSL-dynamic
    points on both sides, so a wider radius there recovers the fast-object
    signal without letting background outliers dominate. Truncation is a
    post-NN clamp, so the wider radius costs nothing."""
    to_pen = lambda m: jnp.where(m, 0.0, _MASK_BIG)  # noqa: E731
    qa, qd = to_pen(valid0), to_pen(valid0 & dynamic0)
    ra, rd = to_pen(valid1), to_pen(valid1 & dynamic1)
    dq_all, dq_dyn, dr_all, dr_dyn = fused_masked_nn(
        warped[:, :3], pc1[:, :3], qa, qd, ra, rd
    )
    cap = max_dist * max_dist
    dyn_dist = max_dist if dynamic_max_dist is None else dynamic_max_dist
    dyn_cap = dyn_dist * dyn_dist
    chamfer = _masked_mean(jnp.minimum(dq_all, cap), valid0) + _masked_mean(
        jnp.minimum(dr_all, cap), valid1
    )
    dyn = _masked_mean(
        jnp.minimum(dq_dyn, dyn_cap), valid0 & dynamic0
    ) + _masked_mean(jnp.minimum(dr_dyn, dyn_cap), valid1 & dynamic1)
    return chamfer, dyn


def nn_distance_sq_reference(query, ref, query_valid=None, ref_valid=None):
    """O(N*M) dense-matrix reference implementation (tests only)."""
    q = query[:, :3]
    r = ref[:, :3]
    d2 = jnp.sum((q[:, None, :] - r[None, :, :]) ** 2, axis=-1)
    if ref_valid is not None:
        d2 = jnp.where(ref_valid[None, :], d2, jnp.inf)
    out = jnp.min(d2, axis=1)
    if query_valid is not None:
        out = jnp.where(query_valid, out, 0.0)
    return out
