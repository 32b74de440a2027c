"""Ground-point classification (grid lowest-z method, jittable).

The reference's .h5 scenes carry a ``ground_mask`` written during
preprocessing by the absent OpenSceneFlow submodule (SURVEY.md §2.5, consumed
at eval.py:290). This op fills that role on the device: rasterize the cloud into
BEV cells, take each cell's minimum z (a segment-min — scatter-free), smooth
with a 3x3 neighborhood min (ground is locally planar), and mark points
within ``threshold`` above the local floor as ground.

Static shapes, one segment reduction + one pooling — runs inside the
ingestion jit or standalone.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class GroundConfig:
    x_range: Tuple[float, float] = (-51.2, 51.2)
    y_range: Tuple[float, float] = (-51.2, 51.2)
    cell_size: float = 1.6
    threshold: float = 0.25  # meters above the local floor counted as ground
    max_ground_z: float = 1.0  # absolute cap: cells floored above this aren't ground

    @property
    def grid_shape(self) -> Tuple[int, int]:
        h = round((self.y_range[1] - self.y_range[0]) / self.cell_size)
        w = round((self.x_range[1] - self.x_range[0]) / self.cell_size)
        return h, w


@partial(jax.jit, static_argnames=("config",))
def ground_mask(
    points: jax.Array,
    valid: jax.Array | None = None,
    config: GroundConfig = GroundConfig(),
) -> jax.Array:
    """(N,) bool — True for points classified as ground.

    Out-of-grid points are never ground (conservative)."""
    h, w = config.grid_shape
    xyz = points[:, :3]
    ix = jnp.floor((xyz[:, 0] - config.x_range[0]) / config.cell_size).astype(jnp.int32)
    iy = jnp.floor((xyz[:, 1] - config.y_range[0]) / config.cell_size).astype(jnp.int32)
    in_grid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    if valid is not None:
        in_grid &= valid
    cell = jnp.where(in_grid, iy * w + ix, h * w)

    big = jnp.asarray(1e9, xyz.dtype)
    z = jnp.where(in_grid, xyz[:, 2], big)
    floor = jax.ops.segment_min(z, cell, num_segments=h * w + 1)[: h * w]
    floor = floor.reshape(h, w)

    # 3x3 neighborhood min: ground is locally planar, so a cell whose floor
    # sits on an object (e.g. a car roof over a fully-occluded cell) inherits
    # the true floor from its neighbors.
    padded = jnp.pad(floor, 1, constant_values=big)
    neighborhood = jnp.stack(
        [
            padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        ]
    ).min(axis=0)

    local_floor = neighborhood.reshape(-1)[jnp.minimum(cell, h * w - 1)]
    is_ground = (
        in_grid
        & (xyz[:, 2] <= local_floor + config.threshold)
        & (local_floor <= config.max_ground_z)
    )
    return is_ground
