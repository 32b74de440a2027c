"""Synthetic multi-LiDAR scenes with analytically known flow & compensation.

The reference ships no test fixtures (SURVEY.md §4); this module is the test
pyramid's foundation: scenes with known rigid ego motion and constant-velocity
box objects, where GT flow, compensation distance, and the de-skewed cloud are
all known in closed form.

Physics of a generated sweep (matching the autolabeler convention at
dataprocess/extract_sca.py:95-145):
- A point on an object with world-frame velocity ``v`` captured at intra-sweep
  time ``dt`` appears at ``base + v * dt`` — the rolling-shutter distortion.
- Stored GT ``flow`` = pose flow + object velocity * sweep_dt (ego frame).
- Therefore motion flow = ``flow - pose_flow`` = ``v_ego * sweep_dt`` and
  ``comp_dis = v_ego * dt0``; the refined cloud is the object's undistorted
  shape at sweep end.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from himo_tpu.core import categories as cat
from himo_tpu.core.transforms import pose_from_yaw_xy, relative_pose
from himo_tpu.data.index import create_reading_index, extract_eval_index
from himo_tpu.data.schema import FrameData, write_frame

SWEEP_DT = 0.1  # 10 Hz sensors


@dataclasses.dataclass
class BoxObject:
    """A box object sampled as a surface point cloud.

    Constant velocity by default; the adversarial extensions let benchmark
    scenes exercise the conditions real data serves up (the matcher stress
    suite's failure modes, scored here under the real eval):

    - ``velocity_schedule``: per-frame (F, 3) m/s overriding ``velocity``
      — stop-and-go, braking, acceleration. Position integrates the
      schedule; the within-sweep smear and the GT flow use the frame's own
      velocity (velocity changes at sweep boundaries).
    - ``visible``: per-frame bools — FOV entry/exit mid-scene.
    - ``occlude_frames``: frames where only the -y local half of the
      surface is sampled (ray-shadow stand-in for partial occlusion).
    """

    center: np.ndarray  # (3,) world position at scene t=0
    velocity: np.ndarray  # (3,) world m/s
    size: np.ndarray  # (3,) l, w, h
    category: str = "REGULAR_VEHICLE"
    points_per_frame: int = 400
    velocity_schedule: Optional[np.ndarray] = None  # (F, 3)
    visible: Optional[Sequence[bool]] = None
    occlude_frames: Sequence[int] = ()

    def velocity_at(self, fi: int) -> np.ndarray:
        if self.velocity_schedule is None:
            return np.asarray(self.velocity, np.float64)
        return np.asarray(
            self.velocity_schedule[min(fi, len(self.velocity_schedule) - 1)],
            np.float64,
        )

    def base_at(self, fi: int) -> np.ndarray:
        """World position at sweep ``fi`` start (schedule integrated)."""
        if self.velocity_schedule is None:
            return np.asarray(self.center, np.float64) + np.asarray(
                self.velocity, np.float64
            ) * (fi * SWEEP_DT)
        disp = np.sum(
            np.asarray(self.velocity_schedule[:fi], np.float64), axis=0
        ) * SWEEP_DT if fi > 0 else 0.0
        return np.asarray(self.center, np.float64) + disp


def _sample_box_points(rng, n: int, size: np.ndarray) -> np.ndarray:
    """Sample points on the surface of an axis-aligned box centered at origin."""
    pts = rng.uniform(-0.5, 0.5, size=(n, 3)) * size
    # Push each point to a random face so the cloud looks like a LiDAR shell.
    face_axis = rng.integers(0, 3, size=n)
    face_sign = rng.choice([-1.0, 1.0], size=n)
    pts[np.arange(n), face_axis] = 0.5 * size[face_axis] * face_sign
    return pts


def lidar_like_cloud(rng, batch: int, n: int) -> np.ndarray:
    """LiDAR-ish occupancy: radial density falloff, ground band + structure,
    a few dense object clusters — matches real pillar-duplicate statistics
    far better than uniform noise."""
    out = np.empty((batch, n, 3), np.float32)
    for b in range(batch):
        n_ground = int(n * 0.45)
        n_struct = int(n * 0.45)
        n_obj = n - n_ground - n_struct
        # Ground: radius ~ sqrt-uniform (denser near the sensor), low z.
        r = 50.0 * np.sqrt(rng.uniform(0.004, 1.0, n_ground))
        a = rng.uniform(0, 2 * np.pi, n_ground)
        ground = np.stack(
            [r * np.cos(a), r * np.sin(a), rng.normal(-1.6, 0.05, n_ground)], 1
        )
        # Structure: annulus walls/vegetation with vertical extent.
        r = 50.0 * np.sqrt(rng.uniform(0.01, 1.0, n_struct))
        a = rng.uniform(0, 2 * np.pi, n_struct)
        struct = np.stack(
            [r * np.cos(a), r * np.sin(a), rng.uniform(-1.5, 2.5, n_struct)], 1
        )
        # Objects: 16 dense clusters (cars/trucks).
        centers = rng.uniform(-45, 45, size=(16, 3))
        centers[:, 2] = rng.uniform(-1.0, 0.5, 16)
        idx = rng.integers(0, 16, n_obj)
        obj = centers[idx] + rng.normal(0, [1.8, 0.9, 0.6], (n_obj, 3))
        out[b] = np.concatenate([ground, struct, obj]).astype(np.float32)
    return out


def make_scene(output_dir, scene_id: str = "scene_000", **scene_kwargs) -> Path:
    """Write a synthetic scene .h5 (see :func:`scene_frames`) and return its
    path."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    frames = scene_frames(**scene_kwargs)
    scene_path = output_dir / f"{scene_id}.h5"
    if scene_path.exists():
        scene_path.unlink()
    import h5py

    with h5py.File(scene_path, "w") as f:
        for frame in frames:
            write_frame(f, frame)
    return scene_path


def scene_frames(
    num_frames: int = 5,
    num_background: int = 4000,
    objects: Optional[Sequence[BoxObject]] = None,
    ego_speed: float = 15.0,
    ego_yaw_rate: float = 0.02,
    num_lidars: int = 3,
    seed: int = 0,
    method_flows=(),
    method_noise: float = 0.0,
) -> List[FrameData]:
    """One synthetic scene's frames, in memory.

    ``method_flows`` adds estimated-flow fields: either a mapping
    ``{name: noise_std}`` or a sequence of names which all use
    ``method_noise``. Each field is the exact GT flow plus Gaussian noise of
    the given std (0 -> a 'perfect' estimator whose MPE/CDE must evaluate to
    ~0, the GT-vs-GT self-consistency gate of SURVEY.md §4).
    """
    if not isinstance(method_flows, dict):
        method_flows = {
            m: (0.0 if m == "perfect" else method_noise) for m in method_flows
        }
    rng = np.random.default_rng(seed)

    if objects is None:
        objects = [
            BoxObject(
                center=np.array([25.0, 5.0, 1.0]),
                velocity=np.array([22.0, 0.5, 0.0]),
                size=np.array([4.5, 2.0, 1.6]),
                category="REGULAR_VEHICLE",
            ),
            BoxObject(
                center=np.array([15.0, -8.0, 1.5]),
                velocity=np.array([-15.0, 0.0, 0.0]),
                size=np.array([9.0, 2.6, 3.2]),
                category="TRUCK",
            ),
        ]

    # Static background: annulus around the ego trajectory.
    bg_radius = rng.uniform(6.0, 40.0, size=num_background)
    bg_angle = rng.uniform(0, 2 * np.pi, size=num_background)
    bg_world = np.stack(
        [
            bg_radius * np.cos(bg_angle),
            bg_radius * np.sin(bg_angle),
            rng.uniform(-0.2, 4.0, size=num_background),
        ],
        axis=1,
    )
    bg_ground = rng.random(num_background) < 0.3
    bg_world[bg_ground, 2] = rng.uniform(-0.05, 0.05, size=int(bg_ground.sum()))

    frames: List[FrameData] = []
    poses = []
    base_ts = 1_700_000_000_000_000_000  # ns epoch, AV2-style timestamp keys
    for fi in range(num_frames):
        t = fi * SWEEP_DT
        yaw = ego_yaw_rate * t
        x = ego_speed * t
        y = 0.0
        poses.append(pose_from_yaw_xy(yaw, x, y))

    for fi in range(num_frames):
        t = fi * SWEEP_DT
        pose0 = poses[fi]
        inv_pose0 = np.linalg.inv(pose0)

        # --- background points (static world) ---
        n_bg = num_background
        bg_dt = rng.uniform(0.0, SWEEP_DT, size=n_bg).astype(np.float32)
        bg_pts_world = bg_world  # static: capture time does not move them
        chunks = [bg_pts_world]
        dts = [bg_dt]
        ids = [rng.integers(1, num_lidars + 1, size=n_bg).astype(np.uint8)]
        inst = [np.zeros(n_bg, dtype=np.uint32)]
        cats = [np.zeros(n_bg, dtype=np.uint8)]
        vels = [np.zeros((n_bg, 3))]
        ground = [bg_ground]

        # --- object points (distorted by capture time) ---
        for oi, obj in enumerate(objects):
            if obj.visible is not None and not obj.visible[min(fi, len(obj.visible) - 1)]:
                continue
            n = obj.points_per_frame
            local = _sample_box_points(rng, n, obj.size)
            if fi in tuple(obj.occlude_frames):
                local = local[local[:, 1] <= 0.0]
                n = len(local)
                if n == 0:
                    continue
            vel_f = obj.velocity_at(fi)
            obj_dt = rng.uniform(0.0, SWEEP_DT, size=n).astype(np.float32)
            base = obj.base_at(fi)
            world = base + local + vel_f[None, :] * obj_dt[:, None]
            chunks.append(world)
            dts.append(obj_dt)
            ids.append(rng.integers(1, num_lidars + 1, size=n).astype(np.uint8))
            inst.append(np.full(n, oi + 1, dtype=np.uint32))
            cats.append(
                np.full(n, cat.CATEGORY_TO_INDEX[cat.NAME_MAPPING[obj.category]], np.uint8)
            )
            vels.append(np.tile(vel_f, (n, 1)))
            ground.append(np.zeros(n, dtype=bool))

        world_pts = np.concatenate(chunks).astype(np.float64)
        lidar_dt = np.concatenate(dts).astype(np.float32)
        lidar_id = np.concatenate(ids)
        instance_id = np.concatenate(inst)
        category_idx = np.concatenate(cats)
        velocity = np.concatenate(vels)
        ground_mask = np.concatenate(ground)

        # Into ego0 frame.
        pc0 = (world_pts @ inv_pose0[:3, :3].T + inv_pose0[:3, 3]).astype(np.float32)
        intensity = rng.random(len(pc0)).astype(np.float32)
        lidar = np.concatenate([pc0, intensity[:, None]], axis=1)

        # GT flow: pose flow + per-point object velocity (rotated into ego0).
        pose1 = poses[min(fi + 1, num_frames - 1)]
        ego1_T_ego0 = relative_pose(pose0, pose1)
        pflow = (
            pc0[:, :3] @ ego1_T_ego0[:3, :3].T + ego1_T_ego0[:3, 3] - pc0[:, :3]
        ).astype(np.float32)
        vel_ego0 = (velocity @ inv_pose0[:3, :3].T).astype(np.float32)
        flow = pflow + vel_ego0 * SWEEP_DT

        extras = {}
        for m, noise_std in method_flows.items():
            noise = (
                rng.normal(0.0, noise_std, size=flow.shape).astype(np.float32)
                if noise_std > 0
                else 0.0
            )
            extras[m] = (flow + noise).astype(np.float32)

        frames.append(
            FrameData(
                lidar=lidar,
                lidar_id=lidar_id,
                lidar_dt=lidar_dt,
                pose=poses[fi],
                timestamp=base_ts + int(t * 1e9),
                lidar_center=np.tile(np.eye(4, dtype=np.float32), (num_lidars, 1, 1)),
                flow=flow,
                flow_is_valid=np.ones(len(pc0), dtype=bool),
                flow_category_indices=category_idx,
                flow_instance_id=instance_id,
                ego_motion=ego1_T_ego0.astype(np.float32),
                ground_mask=ground_mask,
                extras=extras,
            )
        )
    return frames


def make_dataset(
    output_dir,
    num_scenes: int = 2,
    num_frames: int = 5,
    seed: int = 0,
    **scene_kwargs,
) -> Path:
    """Write a full synthetic dataset: scenes + index_total.pkl + index_eval.pkl.

    The eval index excludes each scene's final frame (no successor pose).
    """
    output_dir = Path(output_dir)
    for si in range(num_scenes):
        make_scene(
            output_dir,
            scene_id=f"scene_{si:03d}",
            num_frames=num_frames,
            seed=seed + si,
            **scene_kwargs,
        )
    total = create_reading_index(output_dir, save=True)
    eval_entries = []
    last_by_scene = {}
    for scene_id, ts in total:
        last_by_scene[scene_id] = ts
    for scene_id, ts in total:
        if ts != last_by_scene[scene_id]:
            eval_entries.append([scene_id, ts])
    from himo_tpu.data.index import save_index, INDEX_EVAL

    save_index(eval_entries, output_dir, INDEX_EVAL)
    return output_dir


def adversarial_objects(
    rng, num_frames: int, kind: str, points_per_object: int = 400
) -> List[BoxObject]:
    """Objects for one adversarial scene (the matcher stress suite's
    failure modes, scored under the real eval): 'crossing' paths that
    intersect mid-scene, 'occlusion' (half-shadowed target near a clean
    mover), 'stopgo' (brake to zero / pull away), 'enterleave' (FOV entry
    and exit mid-scene)."""
    car = np.array([4.5, 2.0, 1.6])
    truck = np.array([9.0, 2.6, 3.2])
    if kind == "crossing":
        # Two fast objects whose paths cross between frames 1 and 2.
        meet = np.array([14.0, 3.0, 1.0])
        t_meet = (num_frames // 2) * SWEEP_DT
        v1 = 18.0 * np.array([np.cos(0.4), np.sin(0.4), 0.0])
        v2 = 22.0 * np.array([np.cos(2.4), np.sin(2.4), 0.0])
        return [
            BoxObject(meet - v1 * t_meet + [0, 1.6, 0], v1, car.copy(),
                      "REGULAR_VEHICLE", points_per_object),
            BoxObject(meet - v2 * t_meet - [0, 1.6, 0], v2, truck.copy(),
                      "TRUCK", points_per_object),
        ]
    if kind == "occlusion":
        # A mover half-shadowed in the middle frames next to a clean one.
        occ = tuple(range(1, num_frames - 1))
        return [
            BoxObject(np.array([16.0, -4.0, 1.0]),
                      np.array([20.0, 2.0, 0.0]), car.copy(),
                      "REGULAR_VEHICLE", points_per_object,
                      occlude_frames=occ),
            BoxObject(np.array([-12.0, 8.0, 1.2]),
                      np.array([-6.0, -14.0, 0.0]), truck.copy(),
                      "TRUCK", points_per_object),
        ]
    if kind == "stopgo":
        # Emergency brake to rest, and a pull-away from rest.
        brake = np.zeros((num_frames, 3))
        brake[:, 0] = np.maximum(24.0 - 12.0 * np.arange(num_frames), 0.0)
        pull = np.zeros((num_frames, 3))
        pull[:, 1] = np.minimum(6.0 * np.arange(num_frames), 16.0)
        return [
            BoxObject(np.array([10.0, 6.0, 1.0]), brake[0], car.copy(),
                      "REGULAR_VEHICLE", points_per_object,
                      velocity_schedule=brake),
            BoxObject(np.array([-8.0, -10.0, 1.2]), pull[0], truck.copy(),
                      "TRUCK", points_per_object, velocity_schedule=pull),
        ]
    if kind == "enterleave":
        visible_late = [fi >= 1 for fi in range(num_frames)]
        visible_early = [fi < num_frames - 1 for fi in range(num_frames)]
        return [
            BoxObject(np.array([20.0, 10.0, 1.0]),
                      np.array([-19.0, -4.0, 0.0]), car.copy(),
                      "REGULAR_VEHICLE", points_per_object,
                      visible=visible_late),
            BoxObject(np.array([-15.0, -6.0, 1.2]),
                      np.array([8.0, 21.0, 0.0]), truck.copy(),
                      "TRUCK", points_per_object, visible=visible_early),
        ]
    raise KeyError(f"unknown adversarial kind {kind!r}")


ADVERSARIAL_KINDS = ("crossing", "occlusion", "stopgo", "enterleave")


def make_benchmark_dataset(
    output_dir,
    num_scenes: int = 18,
    num_frames: int = 4,
    seed: int = 0,
    objects_per_scene: int = 6,
    points_per_object: int = 400,
    num_background: int = 16000,
    adversarial_scenes: int = 8,
    **scene_kwargs,
) -> Path:
    """Bucket-complete validation suite for quality-parity evidence.

    Objects systematically cover every (metacategory, velocity bucket,
    distance bucket) cell of the reference eval table — CAR and
    OTHER_VEHICLES at ~6/15/25/34 m/s starting ~6/15/25/34 m out, with
    mixed tangential/radial headings so the distance buckets also fill from
    motion. Default 18 scenes x (num_frames - 1) eval frames = 54 frames.

    ``adversarial_scenes`` appends ``scene_adv_*`` scenes cycling the
    :data:`ADVERSARIAL_KINDS` (crossing / occlusion / stop-and-go /
    FOV entry+exit) so the SCORED table also measures the conditions the
    matcher stress suite exercises as pass/fail tests. Evaluate them
    separately with the eval CLIs' ``scene_filter="scene_adv"``.
    """
    cat_specs = {
        "REGULAR_VEHICLE": np.array([4.5, 2.0, 1.6]),
        "TRUCK": np.array([9.0, 2.6, 3.2]),
    }
    speeds = (6.0, 15.0, 25.0, 34.0)
    dists = (6.0, 15.0, 25.0, 34.0)
    combos = [
        (c, v, d) for c in cat_specs for v in speeds for d in dists
    ]  # 32 cells
    output_dir = Path(output_dir)
    slot = 0
    for si in range(num_scenes):
        rng = np.random.default_rng(seed + 1000 + si)
        objects = []
        for _ in range(objects_per_scene):
            cname, speed, dist = combos[slot % len(combos)]
            slot += 1
            ang = rng.uniform(0, 2 * np.pi)
            center = np.array(
                [dist * np.cos(ang), dist * np.sin(ang), 1.0]
            )
            # Heading: tangential +- up to 45 deg of radial drift.
            head = ang + np.pi / 2 + rng.uniform(-np.pi / 4, np.pi / 4)
            velocity = speed * np.array([np.cos(head), np.sin(head), 0.0])
            objects.append(
                BoxObject(
                    center=center,
                    velocity=velocity,
                    size=cat_specs[cname].copy(),
                    category=cname,
                    points_per_frame=points_per_object,
                )
            )
        make_scene(
            output_dir,
            scene_id=f"scene_{si:03d}",
            num_frames=num_frames,
            seed=seed + si,
            objects=objects,
            num_background=num_background,
            ego_speed=5.0,
            **scene_kwargs,
        )
    for ai in range(adversarial_scenes):
        kind = ADVERSARIAL_KINDS[ai % len(ADVERSARIAL_KINDS)]
        rng = np.random.default_rng(seed + 5000 + ai)
        make_scene(
            output_dir,
            scene_id=f"scene_adv_{ai:03d}",
            num_frames=num_frames,
            seed=seed + 5000 + ai,
            objects=adversarial_objects(
                rng, num_frames, kind, points_per_object
            ),
            num_background=num_background,
            ego_speed=5.0,
            **scene_kwargs,
        )
    total = create_reading_index(output_dir, save=True)
    last_by_scene = {}
    for scene_id, ts in total:
        last_by_scene[scene_id] = ts
    eval_entries = [
        [scene_id, ts] for scene_id, ts in total if ts != last_by_scene[scene_id]
    ]
    from himo_tpu.data.index import save_index, INDEX_EVAL

    save_index(eval_entries, output_dir, INDEX_EVAL)
    return output_dir
