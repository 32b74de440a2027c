"""Raw Scania superframes -> .h5 scenes with GT-flow autolabels.

Drop-in surface for the reference's ``dataprocess/extract_sca.py::main``
(:240-288):

    python -m himo_tpu.cli.extract_scania origin_data=... metadata_pkl=... \\
        output_dir=... nproc=16
    python -m himo_tpu.cli.extract_scania output_dir=... create_index_only=True

Scenes process in parallel worker processes; completed scenes are skipped
(idempotent resume). A reading index is built at the end.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
from pathlib import Path

from himo_tpu.utils.cli import pin_worker_to_cpu, run_cli


def _proc(args):
    from himo_tpu.data.scania import process_scene

    return process_scene(*args)


def main(
    origin_data: str = "",
    metadata_pkl: str = "",
    output_dir: str = "",
    nproc: int = max(multiprocessing.cpu_count() - 1, 1),
    create_index_only: bool = False,
):
    from himo_tpu.data.index import create_reading_index

    if create_index_only:
        create_reading_index(Path(output_dir))
        return

    with open(metadata_pkl, "rb") as f:
        metadata = pickle.load(f)

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    scenes, metas = [], []
    for scene_id in sorted(os.listdir(origin_data)):
        if not os.path.isdir(os.path.join(origin_data, scene_id)):
            continue
        if "batch" not in scene_id:
            continue
        meta = [m for m in metadata if m.get("sample_idx") == scene_id]
        if meta:
            scenes.append(scene_id)
            metas.append(meta)

    args = [
        (origin_data, Path(output_dir), scenes[i], metas[i]) for i in range(len(scenes))
    ]
    print(f"Using {nproc} processes for creating {len(scenes)} scenes.")
    if nproc <= 1:
        for a in args:
            _proc(a)
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes=nproc, initializer=pin_worker_to_cpu) as pool:
            list(pool.imap_unordered(_proc, args))

    create_reading_index(Path(output_dir))


if __name__ == "__main__":
    run_cli(main)
