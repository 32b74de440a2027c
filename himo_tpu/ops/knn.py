"""k-nearest-neighbor distances (small k).

Extends the NN search of :mod:`himo_tpu.ops.nn` to the k smallest squared
distances per query (the CUDA KNN role inside the reference's absent
OpenSceneFlow submodule, SURVEY §2.9 — richer SSL/ICP losses consume
multi-neighbor distances). Same difference form and query chunking as the
NN search, with ``lax.top_k`` in place of the min.

Distances only (no indices): the loss consumers (smoothed chamfer,
neighbor-consistency terms) need the k distances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from himo_tpu.ops.nn import _by_query_chunk, _masked, _sq_dist


def knn_distance_sq(
    query: jax.Array,
    ref: jax.Array,
    k: int,
    query_valid: jax.Array | None = None,
    ref_valid: jax.Array | None = None,
) -> jax.Array:
    """(N, k) smallest squared distances to the reference cloud, ascending.

    Invalid refs never win; invalid queries get 0. Not differentiable (loss
    consumers wrap it in stop-gradient terms or use the k=1 custom-VJP path
    of ops.nn)."""
    q3 = _masked(query, query_valid).astype(jnp.float32)
    rt = _masked(ref, ref_valid).astype(jnp.float32).T
    d2 = _by_query_chunk(
        lambda qc: -jax.lax.top_k(-_sq_dist(qc, rt), k)[0], q3, rt.shape[1], axis=0
    )
    if query_valid is not None:
        d2 = jnp.where(query_valid[:, None], d2, 0.0)
    return d2


def knn_smoothed_chamfer(
    pc1: jax.Array,
    pc2: jax.Array,
    k: int = 4,
    valid1: jax.Array | None = None,
    valid2: jax.Array | None = None,
    max_dist: float = 2.0,
) -> jax.Array:
    """Truncated symmetric chamfer over the mean of the k nearest neighbors.

    Averaging k neighbors smooths the loss surface over sampling noise (a
    single-NN chamfer locks onto one point per query; under resampling the
    minimizer jitters by the point spacing). Non-differentiable through the
    neighbor SELECTION but the distance VALUES carry gradients via the k=1
    identity trick: d2_knn = stop_grad(d2_knn - d2_nn) + d2_nn keeps the
    backward exact for the nearest neighbor while the extra neighbors shape
    the forward value.
    """
    from himo_tpu.ops.nn import nn_distance_sq

    cap = max_dist * max_dist

    def one_side(a, b, va, vb):
        dk = jax.lax.stop_gradient(
            jnp.mean(jnp.minimum(knn_distance_sq(a, b, k, va, vb), cap), axis=1)
        )
        d1 = jnp.minimum(nn_distance_sq(a, b, va, vb), cap)
        d = dk - jax.lax.stop_gradient(d1) + d1  # value: k-mean, grad: k=1
        if va is None:
            return jnp.mean(d)
        return jnp.sum(jnp.where(va, d, 0.0)) / jnp.maximum(
            jnp.sum(va.astype(d.dtype)), 1.0
        )

    return one_side(pc1, pc2, valid1, valid2) + one_side(pc2, pc1, valid2, valid1)
