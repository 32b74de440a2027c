"""Euclidean distance transform on a voxel grid + trilinear sampling.

FastNSF's accelerant: replace per-iteration nearest-neighbor queries with a
precomputed distance-to-cloud field, then optimize flow against trilinear
lookups (Fast Neural Scene Flow, arXiv 2304.09121 — PAPERS.md). The
reference gets this from a CUDA KD-tree; here the squared EDT is computed
exactly with the separable lower-envelope identity

    dt(x) = min_y ( f(y) + (x - y)^2 * spacing^2 )

applied per axis — each 1-D envelope is a broadcast (L, L) min,
batched over rows with ``lax.map`` to bound peak memory. No sequential
Felzenszwalb scans, no data-dependent control flow: everything is static
shapes and dense vector math, which is exactly what XLA wants.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

_BIG = 1.0e12  # "infinite" squared distance for empty cells


@dataclasses.dataclass(frozen=True)
class DTConfig:
    """Voxel grid geometry for the distance field."""

    x_range: Tuple[float, float] = (-51.2, 51.2)
    y_range: Tuple[float, float] = (-51.2, 51.2)
    z_range: Tuple[float, float] = (-3.2, 3.2)
    voxel_size: Tuple[float, float, float] = (0.4, 0.4, 0.4)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (
            round((self.x_range[1] - self.x_range[0]) / self.voxel_size[0]),
            round((self.y_range[1] - self.y_range[0]) / self.voxel_size[1]),
            round((self.z_range[1] - self.z_range[0]) / self.voxel_size[2]),
        )

    @property
    def origin(self) -> Tuple[float, float, float]:
        return (self.x_range[0], self.y_range[0], self.z_range[0])


class DTGrid(NamedTuple):
    dist_sq: jax.Array  # (X, Y, Z) squared distance to the cloud, meters^2
    config: DTConfig


def _envelope_last_axis(f: jax.Array, spacing: float) -> jax.Array:
    """1-D squared-distance lower envelope along the last axis."""
    length = f.shape[-1]
    idx = jnp.arange(length, dtype=jnp.float32)
    d2 = ((idx[:, None] - idx[None, :]) * spacing) ** 2  # (L, L)
    lead = f.shape[:-1]
    flat = f.reshape(-1, length)

    # Chunk the batch so the (chunk, L, L) broadcast stays a few MB.
    chunk = max(1, (4 << 20) // (length * length * 4))
    pad = -flat.shape[0] % chunk
    flat = jnp.pad(flat, ((0, pad), (0, 0)), constant_values=_BIG)
    batched = flat.reshape(-1, chunk, length)

    def one(block):  # (chunk, L)
        return jnp.min(block[:, None, :] + d2[None, :, :], axis=-1)

    out = jax.lax.map(one, batched).reshape(-1, length)
    if pad:
        out = out[: -pad or None]
    return out[: flat.shape[0] - pad].reshape(*lead, length)


def distance_transform(
    points: jax.Array,
    valid: jax.Array | None = None,
    config: DTConfig = DTConfig(),
) -> DTGrid:
    """Squared-distance field of a point cloud over a static voxel grid.

    Occupied cells start at 0 (distance measured cell-center to cell-center —
    a half-voxel quantization, the standard FastNSF trade); three separable
    envelope passes make it an exact grid EDT.
    """
    return DTGrid(_distance_field(points, valid, config), config)


@partial(jax.jit, static_argnames=("config",))
def _distance_field(
    points: jax.Array,
    valid: jax.Array | None,
    config: DTConfig,
) -> jax.Array:
    gx, gy, gz = config.grid_shape
    ox, oy, oz = config.origin
    vx, vy, vz = config.voxel_size

    xyz = points[:, :3]
    ix = jnp.floor((xyz[:, 0] - ox) / vx).astype(jnp.int32)
    iy = jnp.floor((xyz[:, 1] - oy) / vy).astype(jnp.int32)
    iz = jnp.floor((xyz[:, 2] - oz) / vz).astype(jnp.int32)
    in_range = (
        (ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gy) & (iz >= 0) & (iz < gz)
    )
    if valid is not None:
        in_range &= valid
    flat = jnp.where(in_range, (ix * gy + iy) * gz + iz, gx * gy * gz)
    occupancy = jax.ops.segment_max(
        jnp.ones_like(flat, dtype=jnp.float32),
        flat,
        num_segments=gx * gy * gz + 1,
    )[:-1]
    f = jnp.where(occupancy > 0, 0.0, _BIG).reshape(gx, gy, gz)

    f = _envelope_last_axis(f, vz)  # along z
    f = _envelope_last_axis(f.transpose(0, 2, 1), vy).transpose(0, 2, 1)  # y
    f = _envelope_last_axis(f.transpose(1, 2, 0), vx).transpose(2, 0, 1)  # x
    return f


def sample_dt(grid: DTGrid, points: jax.Array) -> jax.Array:
    """Trilinear-interpolated squared distance at arbitrary positions.

    Cell centers are the sample sites; queries are clamped to the grid, so
    out-of-range points read the border distance (finite, keeps gradients
    sane during optimization).
    """
    cfg = grid.config
    gx, gy, gz = cfg.grid_shape
    ox, oy, oz = cfg.origin
    vx, vy, vz = cfg.voxel_size

    # Continuous grid coordinates with cell centers at integer positions.
    u = (points[:, 0] - ox) / vx - 0.5
    v = (points[:, 1] - oy) / vy - 0.5
    w = (points[:, 2] - oz) / vz - 0.5
    u = jnp.clip(u, 0.0, gx - 1.0)
    v = jnp.clip(v, 0.0, gy - 1.0)
    w = jnp.clip(w, 0.0, gz - 1.0)

    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    w0 = jnp.floor(w).astype(jnp.int32)
    u1 = jnp.minimum(u0 + 1, gx - 1)
    v1 = jnp.minimum(v0 + 1, gy - 1)
    w1 = jnp.minimum(w0 + 1, gz - 1)
    fu, fv, fw = u - u0, v - v0, w - w0

    d = grid.dist_sq

    def at(i, j, k):
        return d[i, j, k]

    c000 = at(u0, v0, w0)
    c100 = at(u1, v0, w0)
    c010 = at(u0, v1, w0)
    c110 = at(u1, v1, w0)
    c001 = at(u0, v0, w1)
    c101 = at(u1, v0, w1)
    c011 = at(u0, v1, w1)
    c111 = at(u1, v1, w1)

    c00 = c000 * (1 - fu) + c100 * fu
    c10 = c010 * (1 - fu) + c110 * fu
    c01 = c001 * (1 - fu) + c101 * fu
    c11 = c011 * (1 - fu) + c111 * fu
    c0 = c00 * (1 - fv) + c10 * fv
    c1 = c01 * (1 - fv) + c11 * fv
    return c0 * (1 - fw) + c1 * fw
