"""Fixed-size padding & bucketing for variable-N point clouds.

XLA compiles one program per static shape; multi-LiDAR sweeps have ragged
point counts (the reference handles this with per-frame Python loops —
SURVEY.md §5 "long-context" note). We pad every cloud up to a small set of
bucket sizes so at most ``len(buckets)`` programs are ever compiled, and carry
a boolean ``valid`` mask so padding never affects results.

Bucket sizes are multiples of 1024 so padded arrays divide evenly into the
power-of-two blocks GPU kernels use.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# Default buckets cover demo scenes up to dense multi-LiDAR Scania
# superframes. 1.5x intermediate steps bound the padding waste at 33%
# (pure powers of two cost up to 2x, which the quadratic-NN optimization
# estimators pay SQUARED — an 18k cloud in a 32k bucket ran its chamfer
# 3.2x too slow); each bucket is still a one-time compile.
DEFAULT_BUCKETS: Tuple[int, ...] = (
    8192,
    12288,
    16384,
    24576,
    32768,
    49152,
    65536,
    98304,
    131072,
    196608,
    262144,
)

_TILE = 1024


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; falls back to next multiple of 1024 above the max."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + _TILE - 1) // _TILE) * _TILE


def pad_to_bucket(
    arrays: Dict[str, np.ndarray],
    n: int | None = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Pad every (N, ...) array in ``arrays`` to a common bucket size.

    Returns (padded_arrays, valid_mask). Padded rows are zero-filled; the mask
    marks real rows. ``n`` overrides the inferred row count (useful when some
    arrays are already padded).
    """
    if not arrays:
        raise ValueError("no arrays to pad")
    counts = {k: len(v) for k, v in arrays.items()}
    if n is None:
        n = max(counts.values())
    target = bucket_size(n, buckets)

    padded: Dict[str, np.ndarray] = {}
    for key, arr in arrays.items():
        pad_rows = target - len(arr)
        if pad_rows < 0:
            raise ValueError(f"array {key!r} longer ({len(arr)}) than bucket {target}")
        widths = [(0, pad_rows)] + [(0, 0)] * (arr.ndim - 1)
        padded[key] = np.pad(arr, widths)
    valid = np.zeros(target, dtype=bool)
    valid[:n] = True
    return padded, valid
