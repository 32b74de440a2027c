"""himo_tpu — motion compensation for multi-LiDAR point clouds, in JAX.

A brand-new JAX/XLA framework with the capabilities of KTH-RPL/HiMo
("HiMo: High-Speed Objects Motion Compensation in Point Clouds", T-RO 2025):
per-point scene flow is repurposed into a rolling-shutter compensation
distance ``comp_dis = flow / sensor_dt * dt0`` that de-skews fast objects in
0.1 s LiDAR sweeps (reference: /root/reference/utils/__init__.py:36-47).

Layout
------
- :mod:`himo_tpu.core`     — compensation math, SE3, AV2 taxonomy (pure JAX).
- :mod:`himo_tpu.data`     — .h5 scene schema, datasets, padding, synthetic scenes.
- :mod:`himo_tpu.ops`      — device ops: NN/chamfer, voxelization,
  points-in-boxes, distance transforms.
- :mod:`himo_tpu.models`   — scene-flow estimators: NSFP/FastNSF (optimization),
  FastFlow3D/DeFlow/SeFlow++ (feed-forward).
- :mod:`himo_tpu.training` — SSL losses, data-parallel trainer, checkpoints.
- :mod:`himo_tpu.parallel` — mesh/sharding helpers for several GPUs.
- :mod:`himo_tpu.eval`     — InstanceMetrics / leaderboard scoring / seg IoU.
- :mod:`himo_tpu.io`       — feather-in-zip submission format.
- :mod:`himo_tpu.cli`      — command-line entry points (eval, save_zip, train, ...).
"""

__version__ = "0.1.0"

from himo_tpu.core.compensation import (  # noqa: F401
    flow_to_comp_dis,
    refine_points,
    ego_points_mask,
    pose_flow,
    dt0_from_lidar_dt,
)
