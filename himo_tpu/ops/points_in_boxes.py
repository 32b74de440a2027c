"""Point-in-rotated-box assignment — JAX replacement for the one CUDA op the
reference imports (mmcv.ops.points_in_boxes_part, dataprocess/
extract_sca.py:20,116-118).

Boxes follow the same convention the autolabeler feeds the CUDA op:
``(x, y, z_bottom, l, w, h, heading)`` with the z coordinate at the box
BOTTOM (the reference shifts centers down by h/2 before the call,
extract_sca.py:105). A point is inside if, after rotating into the box frame,
``|lx| <= l/2 and |ly| <= w/2 and 0 <= z - z_bottom <= h``.

Fully vectorized (N, B) test; the returned id is the FIRST containing box
(argmax of a boolean picks the first True), -1 for background — matching the
part-variant semantics the autolabeler relies on (instance ids shifted +1 so
background becomes 0, extract_sca.py:140).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def points_in_boxes(
    points: jax.Array,
    boxes: jax.Array,
    boxes_valid: jax.Array | None = None,
) -> jax.Array:
    """Assign each point the id of the first box containing it, else -1.

    Args:
        points: (N, >=3).
        boxes: (B, 7) = x, y, z_bottom, l, w, h, heading (radians, about +z).
        boxes_valid: (B,) optional mask for padded box slots.

    Returns:
        (N,) int32 box index in [0, B) or -1.
    """
    xyz = points[:, :3]
    centers = boxes[:, :3]  # z is the bottom face
    dims = boxes[:, 3:6]
    heading = boxes[:, 6]

    d = xyz[:, None, :] - centers[None, :, :]  # (N, B, 3)
    c = jnp.cos(heading)[None, :]
    s = jnp.sin(heading)[None, :]
    lx = c * d[:, :, 0] + s * d[:, :, 1]
    ly = -s * d[:, :, 0] + c * d[:, :, 1]
    lz = d[:, :, 2]

    inside = (
        (jnp.abs(lx) <= dims[None, :, 0] * 0.5)
        & (jnp.abs(ly) <= dims[None, :, 1] * 0.5)
        & (lz >= 0.0)
        & (lz <= dims[None, :, 2])
    )
    if boxes_valid is not None:
        inside &= boxes_valid[None, :]

    any_box = jnp.any(inside, axis=1)
    first = jnp.argmax(inside, axis=1).astype(jnp.int32)
    return jnp.where(any_box, first, -1)
