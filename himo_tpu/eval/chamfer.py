"""Symmetric nearest-neighbor Chamfer distance (host path).

Per-instance evaluation clouds are tiny and ragged (tens to thousands of
points), so eval-time Chamfer stays on host with KD-trees — it is not the perf
path (SURVEY.md §7 step 2). The on-device NN search in
:mod:`himo_tpu.ops.nn` serves the training losses instead.

Definition (reference eval.py:50-62):
``(mean(min_dist(pc1->pc2)) + mean(min_dist(pc2->pc1))) / 2``;
NaN when either cloud is empty.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def chamfer_distance_host(pc1: np.ndarray, pc2: np.ndarray) -> float:
    if len(pc1) == 0 or len(pc2) == 0:
        return float("nan")
    from himo_tpu import native

    if native.available():
        return native.chamfer(np.asarray(pc1), np.asarray(pc2))
    d12, _ = cKDTree(pc2).query(pc1, k=1)
    d21, _ = cKDTree(pc1).query(pc2, k=1)
    return float((np.nanmean(d12) + np.nanmean(d21)) / 2.0)


def mean_point_error(pc1: np.ndarray, pc2: np.ndarray) -> float:
    """Mean L2 error between aligned clouds (reference score.py:195-197)."""
    return float(np.linalg.norm(pc1 - pc2, axis=1).mean())
