"""First-class tracing & profiling (upgrades the reference's wall-clock-only
``Time used:`` prints — SURVEY.md §5).

- :class:`Timer` — named accumulating wall-clock timers with a summary table.
- :func:`stage_timer` — context manager for one stage.
- :func:`trace` — wraps ``jax.profiler.trace`` for TensorBoard-viewable device
  traces, no-op when profiling is disabled.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    """Accumulating named wall-clock timers."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["stage                          total_s    calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            count = self.counts[name]
            lines.append(
                f"{name:<30} {total:>8.3f} {count:>8d} {1e3 * total / max(count, 1):>9.2f}"
            )
        return "\n".join(lines)

    def print_summary(self) -> None:
        print(self.summary())


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        print(f"[timing] {name}: {time.perf_counter() - start:.3f} s")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a jax.profiler trace when ``log_dir`` is set, else no-op."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
