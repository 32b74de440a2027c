"""The .h5 scene format — the contract every layer shares.

One HDF5 file per scene; one group per frame, keyed by the frame timestamp
string. Datasets per group (reference schema: dataprocess/extract_sca.py:76-93,
tools/test/repack_h5_scania.py:23-36; see SURVEY.md §2.5):

| key                     | dtype    | shape   | meaning                          |
|-------------------------|----------|---------|----------------------------------|
| lidar                   | float32  | (N, 4)  | x, y, z, intensity               |
| lidar_id                | uint8    | (N,)    | sensor id (multi-LiDAR rigs)     |
| lidar_dt                | float32  | (N,)    | intra-sweep seconds from start   |
| lidar_center            | float32  | (L,4,4) | per-LiDAR extrinsic (4x4)        |
| pose                    | float64  | (4, 4)  | ego pose (world <- ego)          |
| timestamp               | int64    | ()      | frame timestamp                  |
| flow                    | float32  | (N, 3)  | GT flow incl. ego motion         |
| flow_is_valid           | bool     | (N,)    | GT flow validity                 |
| flow_category_indices   | uint8    | (N,)    | AV2 category index per point     |
| flow_instance_id        | uint32   | (N,)    | instance id (0 = background)     |
| ego_motion              | float32  | (4, 4)  | inv(pose1) @ pose0               |
| ground_mask             | bool     | (N,)    | ground classification            |
| anno_bbx                | float32  | opt.    | annotation boxes                 |
| {method}                | float32  | (N, 3)  | estimated flow per method        |
| seg_valid / seg_{m}     | int      | (N,)    | segmentation labels (downstream) |

Sidecar indices live next to the .h5 files: ``index_total.pkl`` — list of
``[scene_id, timestamp]`` — and optional subset ``index_eval.pkl``
(tools/pkl_extract.py:9-19).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# Canonical dtypes for schema-defined keys (repack_h5_scania.py:23-36 is the
# reference dtype map; uint32 instance ids are kept — consumers cast as needed).
SCHEMA_DTYPES: Dict[str, np.dtype] = {
    "lidar": np.float32,
    "lidar_id": np.uint8,
    "lidar_dt": np.float32,
    "lidar_center": np.float32,
    "pose": np.float64,
    "flow": np.float32,
    "flow_is_valid": np.bool_,
    "flow_category_indices": np.uint8,
    "flow_instance_id": np.uint32,
    "ego_motion": np.float32,
    "ground_mask": np.bool_,
    "anno_bbx": np.float32,
}


@dataclasses.dataclass
class FrameData:
    """In-memory frame record matching one .h5 group."""

    lidar: np.ndarray  # (N, 4)
    lidar_id: np.ndarray  # (N,)
    lidar_dt: np.ndarray  # (N,)
    pose: np.ndarray  # (4, 4)
    timestamp: int
    lidar_center: Optional[np.ndarray] = None  # (L, 4, 4)
    flow: Optional[np.ndarray] = None  # (N, 3)
    flow_is_valid: Optional[np.ndarray] = None  # (N,)
    flow_category_indices: Optional[np.ndarray] = None  # (N,)
    flow_instance_id: Optional[np.ndarray] = None  # (N,)
    ego_motion: Optional[np.ndarray] = None  # (4, 4)
    ground_mask: Optional[np.ndarray] = None  # (N,)
    anno_bbx: Optional[np.ndarray] = None
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # h5 group key; defaults to str(timestamp). Scania scenes key groups by
    # superframe number while `timestamp` holds the epoch-ns capture time.
    group_key: Optional[str] = None

    @property
    def num_points(self) -> int:
        return len(self.lidar)


def frame_arrays(frame: FrameData) -> Dict[str, np.ndarray]:
    """The arrays of one frame's group, keyed as in the .h5 file."""
    out = {
        "lidar": frame.lidar.astype(np.float32),
        "lidar_id": frame.lidar_id.astype(np.uint8),
        "lidar_dt": frame.lidar_dt.astype(np.float32),
        "pose": frame.pose.astype(np.float64),
        "timestamp": np.asarray(frame.timestamp),
    }
    if frame.lidar_center is not None:
        out["lidar_center"] = frame.lidar_center.astype(np.float32)
    if frame.flow is not None:
        out["flow"] = frame.flow.astype(np.float32)
        out["flow_is_valid"] = frame.flow_is_valid.astype(bool)
        out["flow_category_indices"] = frame.flow_category_indices.astype(np.uint8)
    if frame.flow_instance_id is not None:
        out["flow_instance_id"] = frame.flow_instance_id.astype(np.uint32)
    if frame.ego_motion is not None:
        out["ego_motion"] = frame.ego_motion.astype(np.float32)
    if frame.ground_mask is not None:
        out["ground_mask"] = frame.ground_mask.astype(bool)
    if frame.anno_bbx is not None:
        out["anno_bbx"] = frame.anno_bbx.astype(np.float32)
    out.update(frame.extras)
    return out


def write_frame(h5: h5py.File, frame: FrameData) -> None:
    """Write one frame as a group keyed by its timestamp string."""
    group = h5.create_group(frame.group_key or str(frame.timestamp))
    for key, value in frame_arrays(frame).items():
        group.create_dataset(key, data=value)


def read_frame(h5: h5py.File, timestamp, extra_keys=()) -> FrameData:
    """Read one frame group back into a FrameData record."""
    group = h5[str(timestamp)]

    def get(key):
        return group[key][()] if key in group else None

    extras = {k: group[k][()] for k in extra_keys if k in group}
    return FrameData(
        lidar=group["lidar"][()],
        lidar_id=group["lidar_id"][()],
        lidar_dt=group["lidar_dt"][()],
        pose=group["pose"][()],
        timestamp=int(np.asarray(group["timestamp"][()]).item()),
        lidar_center=get("lidar_center"),
        flow=get("flow"),
        flow_is_valid=get("flow_is_valid"),
        flow_category_indices=get("flow_category_indices"),
        flow_instance_id=get("flow_instance_id"),
        ego_motion=get("ego_motion"),
        ground_mask=get("ground_mask"),
        anno_bbx=get("anno_bbx"),
        extras=extras,
    )


def write_method_flow(
    data_dir, scene_id: str, timestamp, method: str, flow: np.ndarray
) -> None:
    """Append (or overwrite) an estimated flow field under the method name.

    This is the write-back contract of the reference's ``save.py`` CLI
    (SURVEY.md §2.9): per-frame (N, 3) float32 flow stored in the frame group.
    """
    path = Path(data_dir) / f"{scene_id}.h5"
    import h5py

    with h5py.File(path, "a") as f:
        group = f[str(timestamp)]
        if method in group:
            del group[method]
        group.create_dataset(method, data=np.asarray(flow, dtype=np.float32))


def scene_ids(data_dir) -> list:
    """All scene ids (h5 file stems) in a data directory, sorted."""
    return sorted(p.stem for p in Path(data_dir).glob("*.h5"))
