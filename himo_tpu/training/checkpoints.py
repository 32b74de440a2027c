"""Checkpoint save/restore — the reference's ``checkpoint=...ckpt`` surface
(README.md:50), stored as plain ``.npz`` files.

A checkpoint is a pytree dict, typically ``{"params": ..., "opt_state": ...,
"step": int}``. It is written as one directory holding ``ckpt.npz``, whose
keys are the leaves' tree paths (``params/UNet_0/Conv_0/kernel``). Restoring
with a ``target`` rebuilds the target's structure (optax states included);
without one, the result is nested dicts keyed by path component. Arrays are
fetched to the host before writing (replicated arrays from their local
copy); with several processes, process 0 writes and the others wait for it.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import jax
import numpy as np

_FILE = "ckpt.npz"


def _key(path) -> str:
    parts = []
    for entry in path:
        for attr in ("key", "idx", "name"):
            if hasattr(entry, attr):
                parts.append(str(getattr(entry, attr)))
                break
    return "/".join(parts)


def _flatten(tree) -> Dict[str, np.ndarray]:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_key(path): np.asarray(leaf) for path, leaf in leaves}


def _write(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    np.savez(tmp / _FILE, **arrays)
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)


def _sync() -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("himo_checkpoint")


def save_checkpoint(path, tree: Dict[str, Any]) -> str:
    path = Path(path).absolute()
    arrays = _flatten(tree)
    if jax.process_index() == 0:
        _write(path, arrays)
    _sync()
    return str(path)


def _latest_step_dir(path: Path) -> Path:
    steps = [int(p.name) for p in path.iterdir() if p.is_dir() and p.name.isdigit()]
    return path / str(max(steps)) if steps else path


def _restore(path: Path, target=None):
    with np.load(path / _FILE) as data:
        arrays = {k: data[k] for k in data.files}
    if target is not None:
        leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
        return jax.tree_util.tree_unflatten(
            treedef, [arrays[_key(p)] for p, _ in leaves]
        )
    tree: Dict[str, Any] = {}
    for key, value in arrays.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def load_checkpoint(path, target: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore a checkpoint.

    Accepts either a direct checkpoint path or a :class:`CheckpointManager`
    directory (numbered step subdirectories, as written by training) — the
    latter resolves to its latest step, so CLIs can simply point at
    ``{run_dir}/ckpts``."""
    path = Path(path).absolute()
    if not (path / _FILE).is_file():
        path = _latest_step_dir(path)
    return _restore(path, target)


class CheckpointManager:
    """Top-k checkpoint retention, mirroring the reference training setup
    (``save_top_model=3``, assets/slurm/ssl-train-av2.sh:32).

    With ``best_metric`` set, retention is by that (lower-is-better) metric
    from the ``metrics`` dict passed to :meth:`save` — the kept k checkpoints
    are the best validation ones, not merely the latest."""

    def __init__(
        self,
        directory,
        keep: int = 3,
        best_metric: Optional[str] = None,
        async_save: bool = True,
    ):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.best_metric = best_metric
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name) for p in self.directory.iterdir()
            if p.is_dir() and p.name.isdigit()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        _sync()

    def _prune(self) -> None:
        steps = self.all_steps()
        if self.best_metric is not None:

            def score(step):
                f = self.directory / str(step) / "metrics.json"
                if not f.is_file():
                    return float("inf")
                return float(json.loads(f.read_text())[self.best_metric])

            steps = sorted(steps, key=lambda s: (score(s), -s))
            drop = steps[self.keep:]
        else:
            drop = steps[: max(len(steps) - self.keep, 0)]
        for step in drop:
            shutil.rmtree(self.directory / str(step), ignore_errors=True)

    def _save_now(self, step: int, arrays, metrics) -> None:
        if jax.process_index() != 0:
            return
        path = self.directory / str(step)
        _write(path, arrays)
        if metrics is not None:
            (path / "metrics.json").write_text(
                json.dumps({k: float(v) for k, v in metrics.items()})
            )
        self._prune()

    def save(self, step: int, tree: Dict[str, Any], metrics: Optional[dict] = None):
        """Persist a checkpoint; with ``async_save`` the file write runs in a
        background thread and training continues — the previous in-flight
        write is drained first so at most one save is outstanding. Sync mode
        blocks until the write is done.

        Returns ``{"drain_s", "dispatch_s"}``: the time spent draining the
        PREVIOUS in-flight save and the time this save call held the
        caller. With async saves, ``drain_s > 0`` at save N+1 is the direct
        measurement that save N was still writing while the training steps
        between the two proceeded."""
        import time as _time

        t0 = _time.perf_counter()
        self.wait_until_finished()
        t1 = _time.perf_counter()
        arrays = _flatten(tree)  # device -> host before the caller goes on
        if self.async_save:
            self._pending = threading.Thread(
                target=self._save_now, args=(step, arrays, metrics)
            )
            self._pending.start()
        else:
            self._save_now(step, arrays, metrics)
        return {"drain_s": t1 - t0, "dispatch_s": _time.perf_counter() - t1}

    def restore_latest(self, target=None):
        self.wait_until_finished()
        step = self.latest_step()
        if step is None:
            return None, None
        return step, _restore(self.directory / str(step), target)

    def close(self):
        """Blocks until every pending async save is on disk."""
        self.wait_until_finished()
