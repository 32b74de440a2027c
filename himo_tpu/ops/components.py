"""On-device connected components + per-component rigid pooling.

The in-net analog of the host matcher's DBSCAN: the network predicts a
per-pillar dynamic logit image, this module labels its connected blobs and
pools one rigid translation per blob — entirely on the device, inside jit,
with static shapes. It gives the feed-forward flagship per-OBJECT decoding
capacity: the pillar decoder's spatially smooth per-point residual cannot
express "exactly zero here, 1.5 m next pillar" (measured round 4), but a
component-pooled mean can, and training through the pooling means the net
only has to get each object's MEAN motion right while the dynamic mask
supplies the sharp boundary.

Reference role: SeFlow++'s SSL clustering at TRAINING time
(/root/reference/assets/slurm/ssl-train-av2.sh:31-34) teaches the reference
net per-object rigidity from 110k real frames; this head bakes the same
structure into the architecture so a pure feed-forward pass (the
reference's deployment profile, /root/reference/README.md:46-53) recovers
it at inference without any host clustering.

Design notes:
- Labels propagate by iterated windowed MIN over the occupancy grid
  (``lax.reduce_window``, no gathers). A window of
  ``2r+1`` connects cells within Chebyshev distance ``r`` per step (the
  grid analog of DBSCAN's ``eps``); empty cells reset to the sentinel each
  step so labels can only travel through occupied cells.
- Component roots compact to a fixed slot budget via one cumsum; per-point
  pooling is two one-hot matmuls — no unsorted scatters anywhere.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def connected_components_grid(
    occ: jax.Array,  # (H, W) bool occupancy
    iters: int = 24,
    reach: int = 2,
) -> jax.Array:
    """Label connected blobs of ``occ``; cells within Chebyshev distance
    ``reach`` of each other connect (through occupied cells only).

    Returns (H, W) int32: the component's minimum flat index ("root") for
    occupied cells, ``H*W`` for empty ones. ``iters`` bounds the labelled
    diameter at ``iters * reach`` cells — size it to the largest object the
    grid must cover (a 15 m truck at 0.4 m cells needs ~38).
    """
    import numpy as np

    h, w = occ.shape
    sentinel = np.int32(h * w)  # static: reduce_window needs a concrete init
    lab = jnp.where(occ, jnp.arange(h * w, dtype=jnp.int32).reshape(h, w), sentinel)
    window = 2 * reach + 1

    def _min2d(x):
        # Separable windowed min (Chebyshev window factorizes per axis).
        x = jax.lax.reduce_window(
            x, sentinel, jax.lax.min, (window, 1), (1, 1), "SAME"
        )
        return jax.lax.reduce_window(
            x, sentinel, jax.lax.min, (1, window), (1, 1), "SAME"
        )

    def body(lab, _):
        lab = jnp.where(occ, _min2d(lab), sentinel)
        return lab, None

    lab, _ = jax.lax.scan(body, lab, None, length=iters)
    return lab


def component_slots(
    labels: jax.Array,  # (H, W) int32 from connected_components_grid
    max_slots: int,
) -> Tuple[jax.Array, jax.Array]:
    """Compact component roots to slot ids in [0, max_slots).

    Returns ``(slot_enc, n_components)`` where ``slot_enc`` is (H, W)
    int32 with value ``slot + 1`` for cells in a slotted component and 0
    for empty cells / overflow components (beyond ``max_slots``, counted in
    scan order of the root index). The +1 encoding survives the
    zero-masking per-point pillar gather (out-of-range points read 0 =
    no component)."""
    h, w = labels.shape
    flat = labels.reshape(-1)
    occ = flat < h * w
    root = occ & (flat == jnp.arange(h * w, dtype=jnp.int32))
    # Slot = rank of this root among roots (cumsum), capped to the budget.
    rank = jnp.cumsum(root.astype(jnp.int32)) - 1
    slot_of_cell = jnp.where(root & (rank < max_slots), rank + 1, 0)
    # Every cell inherits its root's slot (one 1-D gather over cells).
    safe = jnp.minimum(flat, h * w - 1)
    slot_enc = jnp.where(occ, slot_of_cell[safe], 0)
    n_components = jnp.sum(root.astype(jnp.int32))
    return slot_enc.reshape(h, w), n_components


def pool_by_slot(
    values: jax.Array,  # (N, C) per-point values to pool (e.g. raw flow)
    weights: jax.Array,  # (N,) pooling weights (gate probabilities / mask)
    slot: jax.Array,  # (N,) int32 in [-1, max_slots): -1 = no component
    max_slots: int,
    min_weight: float = 3.0,
) -> Tuple[jax.Array, jax.Array]:
    """Weighted per-component mean, distributed back to the points.

    Two one-hot matmuls (HIGHEST precision so bf16/TF32 rounding cannot
    bias an object's pooled translation) — no scatters. Returns
    ``(pooled (N, C), ok (N,) bool)`` where ``ok`` marks points whose
    component accumulated at least ``min_weight`` of pooling mass (pooled
    values elsewhere are meaningless and must not be used)."""
    member = slot >= 0
    s = jnp.where(member, slot, 0)
    onehot = (
        (s[:, None] == jnp.arange(max_slots, dtype=jnp.int32)[None, :])
        & member[:, None]
    ).astype(jnp.float32)
    w = weights.astype(jnp.float32)
    aug = jnp.concatenate(
        [values.astype(jnp.float32) * w[:, None], w[:, None]], axis=1
    )
    sums = jax.lax.dot_general(
        onehot, aug, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # (max_slots, C+1)
    counts = sums[:, -1]
    means = sums[:, :-1] / jnp.maximum(counts, 1e-6)[:, None]
    ok_slot = counts >= min_weight
    pooled = jax.lax.dot_general(
        onehot, jnp.where(ok_slot[:, None], means, 0.0),
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # (N, C)
    ok = member & (onehot @ ok_slot.astype(jnp.float32) > 0.5)
    return pooled, ok
