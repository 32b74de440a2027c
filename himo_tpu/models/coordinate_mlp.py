"""Coordinate MLP shared by the optimization-based estimators.

NSFP-class prior: a small ReLU MLP mapping a 3-D point to its 3-D flow; the
network weights ARE the per-frame optimization variables (one fresh init per
frame pair). Hand-rolled parameter pytrees (no framework state) keep the
whole optimize-loop a single jitted ``lax.scan``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

Params = List[Tuple[jax.Array, jax.Array]]


def init_mlp(
    key: jax.Array,
    hidden: int = 128,
    layers: int = 8,
    in_dim: int = 3,
    out_dim: int = 3,
) -> Params:
    """Glorot-initialized (W, b) list: in -> hidden x layers -> out."""
    dims = [in_dim] + [hidden] * layers + [out_dim]
    params: Params = []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(2.0 / (dims[i] + dims[i + 1]))
        w = jax.random.normal(sub, (dims[i], dims[i + 1]), dtype=jnp.float32) * scale
        b = jnp.zeros((dims[i + 1],), dtype=jnp.float32)
        params.append((w, b))
    return params


def apply_mlp(params: Params, x: jax.Array) -> jax.Array:
    """Forward pass; points batched along axis 0 so each layer is one matmul."""
    h = x
    for w, b in params[:-1]:
        h = jax.nn.relu(h @ w + b)
    w, b = params[-1]
    return h @ w + b
