"""Per-object diagnostic of the fast-object translation priors.

Classifies every fast GT instance (speed >= --min-speed m/s) per frame as
covered-correct / covered-wrong / uncovered, using the instance's GT flow
(the dataset's ``flow`` key) as truth — the measurement protocol behind the
matcher-overhaul numbers in PARITY.md (coverage %, per-point prior error,
scene-start wrong-track tail). Host-side numpy only (no GPU needed):

    python scripts/prior_diagnostic.py \
        [--root /tmp/av2_quality] [--min-speed 20] [--wrong-tol 0.5]

Role: the per-failure-mode dissection HiMo's high-speed regime requires;
see /root/reference/README.md:95 context (the reference never ships such a
tool — its priors come from 110k-frame training).
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/av2_quality")
    ap.add_argument("--min-speed", type=float, default=20.0, help="m/s")
    ap.add_argument("--wrong-tol", type=float, default=0.5, help="m")
    ap.add_argument("--period", type=float, default=0.1, help="s/frame")
    args = ap.parse_args()

    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.training.ssl_labels import label_scene

    dataset = SceneFlowDataset(
        args.root, with_pc1=True, next_keys=("lidar_dt",)
    )
    by_scene = defaultdict(list)
    for i in range(len(dataset)):
        data = dataset[i]
        if not data.get("has_next", True):
            continue  # no successor sweep: nothing to match against
        by_scene[data["scene_id"]].append(data)
    stats = []  # per (scene, frame, instance)
    labeled = (
        (data, fidx, result)
        for sid, frames in by_scene.items()
        for fidx, (data, result) in enumerate(
            zip(frames, label_scene(frames))
        )
    )
    for data, fidx, result in labeled:
        sid = data["scene_id"]
        _, _, prior, prior_valid = result
        gt = np.asarray(data["flow"])  # total flow incl. ego
        # Instance (object) flow = GT minus rigid ego flow.
        from himo_tpu.core.transforms import rigid_flow

        ego = rigid_flow(
            data["pc0"][:, :3], data["pose0"], data["pose1"]
        ).astype(np.float32)
        obj_flow = gt - ego
        inst = np.asarray(data["flow_instance_id"])
        valid = np.asarray(data["flow_is_valid"], bool)
        for iid in np.unique(inst[inst > 0]):
            m = (inst == iid) & valid
            if m.sum() < 10:
                continue
            speed = float(np.linalg.norm(obj_flow[m].mean(0))) / args.period
            if speed < args.min_speed:
                continue
            cov = prior_valid[m]
            frac = float(cov.mean())
            if frac < 0.5:
                stats.append((sid, fidx, int(iid), speed, "uncovered", np.nan))
                continue
            err = float(
                np.linalg.norm(prior[m][cov] - obj_flow[m][cov], axis=1).mean()
            )
            kind = "wrong" if err > args.wrong_tol else "ok"
            stats.append((sid, fidx, int(iid), speed, kind, err))

    n = len(stats)
    kinds = defaultdict(list)
    for s in stats:
        kinds[s[4]].append(s)
    print(f"fast-object frame-instances: {n}")
    for k in ("ok", "wrong", "uncovered"):
        rows = kinds[k]
        print(f"  {k:10s}: {len(rows):4d} ({100*len(rows)/max(n,1):.1f}%)")
    errs = [s[5] for s in kinds["ok"]]
    if errs:
        print(
            f"  covered-ok err: mean {np.mean(errs):.3f} m, "
            f"median {np.median(errs):.3f} m"
        )
    bad = kinds["wrong"] + kinds["uncovered"]
    if bad:
        print("\nfailures by frame index (scene-start tail check):")
        by_f = defaultdict(int)
        for s in bad:
            by_f[s[1]] += 1
        for f in sorted(by_f):
            print(f"  frame {f}: {by_f[f]}")
        print("\nfailure list (scene, frame, inst, speed, kind, err):")
        for s in sorted(bad):
            e = "nan" if np.isnan(s[5]) else f"{s[5]:.2f}"
            print(f"  {s[0]} f{s[1]} inst{s[2]} {s[3]:.1f} m/s {s[4]} {e}")


if __name__ == "__main__":
    main()
