"""Lightweight tracing/profiling.

Two tools:

- :class:`StageTimer` — named wall-clock stage accumulator for host-side
  pipeline stages (decode, pack, dispatch, drain, csv). Callers time
  around real host<->device synchronization points.
- :func:`device_trace` — context manager around ``torch.profiler`` that
  writes a Chrome trace of host and CUDA activity.

Enable pipeline timing globally with ``SYKEPIC_PROFILE=1``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

ENABLED = os.environ.get("SYKEPIC_PROFILE", "") not in ("", "0")


class StageTimer:
    """Accumulates wall-clock per named stage; prints a summary table."""

    def __init__(self, enabled: bool | None = None):
        self.enabled = ENABLED if enabled is None else enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        # stages run concurrently (the engine's metadata worker pool);
        # the += below is a read-modify-write needing the lock
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        lines = ["stage                          total_s   calls    ms/call"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<30} {total:8.3f} {n:7d} {1000 * total / n:10.2f}"
            )
        return "\n".join(lines)

    def report(self) -> None:
        if self.enabled and self.totals:
            print(self.summary())


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a ``torch.profiler`` trace (CPU and, when a card is present,
    CUDA activity) into ``log_dir/trace.json``."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
