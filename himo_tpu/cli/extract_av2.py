"""AV2 sensor logs -> .h5 scenes CLI.

The AV2 counterpart of ``extract_scania`` (the role the reference delegates
to OpenSceneFlow's preprocessing — SURVEY.md §2.5):

    python -m himo_tpu.cli.extract_av2 origin_data=/data/av2/sensor/val \\
        output_dir=/data/av2/h5 nproc=8
"""

from __future__ import annotations

import multiprocessing
import os
from pathlib import Path

from himo_tpu.utils.cli import pin_worker_to_cpu, run_cli


def _proc(args):
    from himo_tpu.data.av2 import process_log

    return process_log(*args)


def main(
    origin_data: str = "",
    output_dir: str = "",
    nproc: int = max(multiprocessing.cpu_count() - 1, 1),
    create_index_only: bool = False,
):
    from himo_tpu.data.index import create_reading_index

    if create_index_only:
        create_reading_index(Path(output_dir))
        return

    logs = sorted(
        d
        for d in os.listdir(origin_data)
        if (Path(origin_data) / d / "sensors" / "lidar").is_dir()
    )
    args = [(Path(origin_data) / log, Path(output_dir), log) for log in logs]
    print(f"Using {nproc} processes for {len(logs)} AV2 logs.")
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
