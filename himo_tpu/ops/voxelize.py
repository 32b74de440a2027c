"""Pillar (2-D voxel) encoding of point clouds.

The feed-forward flow models rasterize clouds into a birds-eye pseudo-image
(PointPillars-style; reference training config ``voxel_size=[0.2,0.2,6]``,
``point_cloud_range=[-51.2,-51.2,-3,51.2,51.2,3]`` — assets/slurm/
ssl-train-av2.sh:32). The reference submodule does this with CUDA scatter
kernels; here the scatters are ``jax.ops.segment_sum``/``segment_max`` with
a static segment count and the gather is a row take, which XLA lowers to
atomic scatters and gathers on the GPU.

All shapes static: N points in, H*W pillars out; out-of-range or padded
points route to a trash segment that is sliced off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PillarConfig:
    """Geometry of the pillar grid."""

    x_range: Tuple[float, float] = (-51.2, 51.2)
    y_range: Tuple[float, float] = (-51.2, 51.2)
    z_range: Tuple[float, float] = (-3.0, 3.0)
    voxel_size: Tuple[float, float] = (0.2, 0.2)

    @property
    def grid_shape(self) -> Tuple[int, int]:
        h = round((self.y_range[1] - self.y_range[0]) / self.voxel_size[1])
        w = round((self.x_range[1] - self.x_range[0]) / self.voxel_size[0])
        return h, w

    @property
    def num_pillars(self) -> int:
        h, w = self.grid_shape
        return h * w


class PillarGrid(NamedTuple):
    """Result of pillar assignment for one cloud."""

    pillar_ids: jax.Array  # (N,) int32 flat pillar index; num_pillars = trash
    in_range: jax.Array  # (N,) bool — inside the grid AND caller-valid
    centers_offset: jax.Array  # (N, 3) offset of each point from pillar center
    grid_shape: Tuple[int, int]


def voxelize_pillars(
    points: jax.Array,
    valid: jax.Array | None = None,
    config: PillarConfig = PillarConfig(),
) -> PillarGrid:
    """Assign each point to a pillar; no scatter happens here.

    Not individually jitted: callers trace it inside their own jit, which
    keeps ``grid_shape`` a static Python tuple (a nested jit would return it
    as traced arrays and break downstream segment reductions)."""
    h, w = config.grid_shape
    xyz = points[:, :3]
    vx, vy = config.voxel_size
    ix = jnp.floor((xyz[:, 0] - config.x_range[0]) / vx).astype(jnp.int32)
    iy = jnp.floor((xyz[:, 1] - config.y_range[0]) / vy).astype(jnp.int32)
    in_range = (
        (ix >= 0)
        & (ix < w)
        & (iy >= 0)
        & (iy < h)
        & (xyz[:, 2] >= config.z_range[0])
        & (xyz[:, 2] <= config.z_range[1])
    )
    if valid is not None:
        in_range &= valid
    flat = jnp.where(in_range, iy * w + ix, h * w)  # trash segment = h*w
    cx = (ix.astype(jnp.float32) + 0.5) * vx + config.x_range[0]
    cy = (iy.astype(jnp.float32) + 0.5) * vy + config.y_range[0]
    cz = jnp.full_like(cx, 0.5 * (config.z_range[0] + config.z_range[1]))
    offset = xyz - jnp.stack([cx, cy, cz], axis=1)
    return PillarGrid(flat, in_range, offset, (h, w))


def scatter_mean(features: jax.Array, grid: PillarGrid) -> jax.Array:
    """Per-pillar mean of point features -> (H, W, C) dense image."""
    h, w = grid.grid_shape
    feats = jnp.where(grid.in_range[:, None], features, 0.0)
    sums = jax.ops.segment_sum(feats, grid.pillar_ids, num_segments=h * w + 1)
    counts = jax.ops.segment_sum(
        grid.in_range.astype(feats.dtype), grid.pillar_ids, num_segments=h * w + 1
    )
    mean = sums[: h * w] / jnp.maximum(counts[: h * w], 1.0)[:, None]
    return mean.reshape(h, w, -1)


def scatter_max(features: jax.Array, grid: PillarGrid) -> jax.Array:
    """Per-pillar max of point features -> (H, W, C) dense image.

    Empty pillars come out as 0 (not -inf)."""
    h, w = grid.grid_shape
    neg = jnp.finfo(features.dtype).min
    feats = jnp.where(grid.in_range[:, None], features, neg)
    mx = jax.ops.segment_max(feats, grid.pillar_ids, num_segments=h * w + 1)
    # Empty segments come back as -inf; masked-point segments as finfo.min.
    mx = jnp.where(mx <= neg, 0.0, mx)
    return mx[: h * w].reshape(h, w, -1)


def gather_pillars(image: jax.Array, grid: PillarGrid) -> jax.Array:
    """Gather each point's pillar feature back from the dense image.

    Out-of-range points get zeros."""
    h, w = grid.grid_shape
    flat = image.reshape(h * w, -1)
    out = flat[jnp.minimum(grid.pillar_ids, h * w - 1)]
    return jnp.where(grid.in_range[:, None], out, 0.0)
