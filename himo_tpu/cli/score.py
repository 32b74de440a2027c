"""Codabench / command-line scoring entry point.

Drop-in surface for the reference's ``tools/test/score.py::main``
(:669-754): autodetects the Codabench ``/app/input/{ref,res}`` ->
``/app/output/scores.json`` layout, else requires ``--gt_zip``/``--pred_zip``.
Both zips and extracted directories are accepted.
"""

from __future__ import annotations

import argparse
from pathlib import Path

try:
    import pyarrow  # noqa: F401
except ImportError as e:  # pragma: no cover - environment-dependent
    raise SystemExit(
        "himo_tpu.cli.score reads .feather archives and needs pyarrow: "
        "pip install pyarrow"
    ) from e

from himo_tpu.eval.score import score


def _find_archive(root: Path, kind: str) -> str:
    zips = sorted(root.glob("*.zip"))
    if zips:
        print(f"Found {kind} zip: {zips[0]}")
        return str(zips[0])
    feathers = list(root.rglob("*.feather"))
    if feathers:
        print(f"Found {len(feathers)} feather files ({kind} is extracted)")
        return str(root)
    raise FileNotFoundError(f"No {kind} data found in {root}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="HiMo benchmark scoring program")
    parser.add_argument("--gt_zip", type=str, default=None)
    parser.add_argument("--pred_zip", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--flow_mode", type=str, default="submission")
    parser.add_argument(
        "--data_name",
        type=str,
        default=None,
        choices=("scania", "av2"),
        help="Override dataset identity when archive names don't contain it",
    )
    args = parser.parse_args(argv)

    codabench_input = Path("/app/input")
    if codabench_input.exists() and args.gt_zip is None:
        print("Detected CodaBench environment")
        gt_path = _find_archive(codabench_input / "ref", "GT")
        pred_path = _find_archive(codabench_input / "res", "prediction")
        output_dir = "/app/output"
        flow_mode = "submission"
    else:
        if args.gt_zip is None or args.pred_zip is None:
            parser.error("--gt_zip and --pred_zip are required when not on CodaBench")
        gt_path, pred_path = args.gt_zip, args.pred_zip
        output_dir, flow_mode = args.output_dir, args.flow_mode

    return score(gt_path, pred_path, output_dir, flow_mode, data_name=args.data_name)


if __name__ == "__main__":
    main()
