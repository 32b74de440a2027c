"""Map-style dataset over .h5 scene directories.

Implements the surface of the reference's ``src.dataset.HDF5Dataset``
(consumed at eval.py:279-310, save_zip.py:111-121; SURVEY.md §2.9):
``dataset[i]`` returns a dict with

    pc0, pose0, pose1, flow, gm0, lidar_dt, flow_is_valid,
    flow_category_indices, flow_instance_id, scene_id, timestamp

plus ``data[vis_name]`` for a stored method-flow field. ``eval=True``
restricts iteration to the frames listed in ``index_eval.pkl``. Built with
``scenes=`` instead of a directory, it serves the same items from frames
held in memory (synthetic scenes, or data decoded elsewhere).
"""

from __future__ import annotations

import contextlib
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from himo_tpu.data.index import (
    INDEX_EVAL,
    INDEX_TOTAL,
    _parse_timestamp,
    _timestamp_sort_key,
    create_reading_index,
)
from himo_tpu.data.schema import FrameData, frame_arrays


class SceneFlowDataset:
    """Frame-pair dataset: each item is a frame plus the next frame's pose.

    ``pose1`` (and optionally ``pc1``/``gm1`` with ``with_pc1=True``) come from
    the chronologically next frame of the same scene; the final frame of a
    scene reuses its own pose (identity ego motion) — evaluation indices never
    include scene-final frames.
    """

    def __init__(
        self,
        data_dir,
        vis_name: str | Sequence[str] = "",
        eval: bool = False,  # noqa: A002 - matching the reference kwarg
        with_pc1: bool = False,
        with_history: bool = False,
        extra_keys: Sequence[str] = (),
        next_keys: Sequence[str] = (),
        scenes: Optional[Dict[str, Sequence[FrameData]]] = None,
    ):
        self.directory = None if data_dir is None else Path(data_dir)
        self.vis_names = (
            [vis_name] if isinstance(vis_name, str) and vis_name else list(vis_name or [])
        )
        self.with_pc1 = with_pc1
        self.with_history = with_history
        self.extra_keys = list(extra_keys)
        # Keys read from the SUCCESSOR frame's group, emitted with a "1"
        # suffix (e.g. next_keys=("ssl_dynamic",) -> out["ssl_dynamic1"]) —
        # the successor's pc0-side labels describe this item's pc1.
        self.next_keys = list(next_keys)

        self._groups = None
        if scenes is not None:
            self._groups = {
                sid: {f.group_key or str(f.timestamp): frame_arrays(f) for f in frames}
                for sid, frames in scenes.items()
            }
            self.data_index = [
                [sid, _parse_timestamp(ts)]
                for sid in sorted(self._groups)
                for ts in sorted(self._groups[sid], key=_timestamp_sort_key)
            ]
        elif (self.directory / INDEX_TOTAL).exists():
            total_path = self.directory / INDEX_TOTAL
            with open(total_path, "rb") as f:
                self.data_index: List[list] = pickle.load(f)
        else:
            self.data_index = create_reading_index(self.directory, save=False)

        self._pos = {
            (scene, ts): i for i, (scene, ts) in enumerate(self.data_index)
        }

        self.eval_index: Optional[List[list]] = None
        if eval:
            eval_path = None if scenes is not None else self.directory / INDEX_EVAL
            if eval_path is not None and eval_path.exists():
                with open(eval_path, "rb") as f:
                    self.eval_index = pickle.load(f)
            else:
                # No eval subset: evaluate every frame that has a successor.
                self.eval_index = [
                    entry
                    for i, entry in enumerate(self.data_index)
                    if self._next_entry(i) is not None
                ]

    def _next_entry(self, index: int) -> Optional[list]:
        """The next frame of the same scene, or None at a scene boundary."""
        if index + 1 >= len(self.data_index):
            return None
        scene_id = self.data_index[index][0]
        nxt = self.data_index[index + 1]
        return nxt if nxt[0] == scene_id else None

    def _prev_entry(self, index: int) -> Optional[list]:
        """The previous frame of the same scene, or None at a scene start."""
        if index == 0:
            return None
        scene_id = self.data_index[index][0]
        prv = self.data_index[index - 1]
        return prv if prv[0] == scene_id else None

    def __len__(self) -> int:
        return len(self.eval_index if self.eval_index is not None else self.data_index)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.eval_index is not None:
            scene_id, timestamp = self.eval_index[index]
            index = self._pos[(scene_id, timestamp)]
        scene_id, timestamp = self.data_index[index]

        nxt = self._next_entry(index)
        out: Dict[str, np.ndarray] = {"scene_id": scene_id, "timestamp": timestamp}
        with self._open(scene_id) as f:
            g = f[str(timestamp)]
            out["pc0"] = g["lidar"][()].astype(np.float32)
            out["pose0"] = g["pose"][()]
            out["lidar_dt"] = g["lidar_dt"][()].astype(np.float32)
            if "lidar_id" in g:
                out["lidar_id"] = g["lidar_id"][()]
            out["gm0"] = (
                g["ground_mask"][()].astype(bool)
                if "ground_mask" in g
                else np.zeros(len(out["pc0"]), dtype=bool)
            )
            for key in (
                "flow",
                "flow_is_valid",
                "flow_category_indices",
                "flow_instance_id",
                "ego_motion",
            ):
                if key in g:
                    out[key] = g[key][()]
            for key in list(self.vis_names) + self.extra_keys:
                if key and key in g:
                    out[key] = g[key][()]

            out["has_next"] = nxt is not None
            if nxt is not None:
                g1 = f[str(nxt[1])]
                out["pose1"] = g1["pose"][()]
                if self.with_pc1:
                    out["pc1"] = g1["lidar"][()].astype(np.float32)
                    out["gm1"] = (
                        g1["ground_mask"][()].astype(bool)
                        if "ground_mask" in g1
                        else np.zeros(len(out["pc1"]), dtype=bool)
                    )
                for key in self.next_keys:
                    if key in g1:
                        out[key + "1"] = g1[key][()]
            else:
                out["pose1"] = out["pose0"]
                if self.with_pc1:
                    out["pc1"] = out["pc0"]
                    out["gm1"] = out["gm0"]

            if self.with_history:
                prv = self._prev_entry(index)
                if prv is not None:
                    gp = f[str(prv[1])]
                    out["pc_prev"] = gp["lidar"][()].astype(np.float32)
                    out["pose_prev"] = gp["pose"][()]
                    out["gm_prev"] = (
                        gp["ground_mask"][()].astype(bool)
                        if "ground_mask" in gp
                        else np.zeros(len(out["pc_prev"]), dtype=bool)
                    )
                else:
                    out["pc_prev"] = out["pc0"]
                    out["pose_prev"] = out["pose0"]
                    out["gm_prev"] = out["gm0"]
        return out

    def _open(self, scene_id: str):
        """The scene's groups: the .h5 file, or the in-memory arrays (numpy
        arrays answer ``[()]`` as h5py datasets do)."""
        if self._groups is not None:
            return contextlib.nullcontext(self._groups[scene_id])
        import h5py

        return h5py.File(self.directory / f"{scene_id}.h5", "r")

    def scene_ids(self) -> List[str]:
        seen, ordered = set(), []
        for scene_id, _ in self.data_index:
            if scene_id not in seen:
                seen.add(scene_id)
                ordered.append(scene_id)
        return ordered


# Alias matching the reference class name for drop-in familiarity.
HDF5Dataset = SceneFlowDataset
