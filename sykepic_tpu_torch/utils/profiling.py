"""Lightweight tracing/profiling.

Two tools:

- :class:`StageTimer` — the port's recorder of host spans and counters.
  A span (:meth:`StageTimer.stage`) accumulates wall clock per name and,
  while enabled, is also a host op of ``torch.profiler``: under a profiler
  it sits in the same trace as the CUDA kernels, on the same clock. A
  counter (:meth:`StageTimer.count`) adds a number per name (ROIs and
  slots dispatched, wire payloads encoded).
- :func:`device_trace` — context manager around ``torch.profiler`` that
  writes a Chrome trace of host and CUDA activity, the spans included.

``SYKEPIC_PROFILE=1`` enables the timers built while it is set; each
classify stream then prints their table at its end.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


def _env_enabled() -> bool:
    return os.environ.get("SYKEPIC_PROFILE", "") not in ("", "0")


class StageTimer:
    """Accumulates wall-clock per named stage and sums per named counter;
    prints a summary table."""

    def __init__(self, enabled: bool | None = None):
        self.enabled = _env_enabled() if enabled is None else enabled
        # stage seconds and counter sums share one mapping, which the
        # benchmark's readers take whole; `counters` names the sums
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: set[str] = set()
        # stages run concurrently (the engine's metadata worker pool);
        # the += below is a read-modify-write needing the lock
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        # an op of the profiler's host timeline, not record_function's user
        # annotation: the profiler copies an annotation onto the device's
        # timeline over the kernels launched inside it, which a reading of
        # the device's busy time would count as work
        from torch._C._profiler import _RecordFunctionFast

        t0 = time.perf_counter()
        try:
            with _RecordFunctionFast(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (a no-op when disabled)."""
        if not self.enabled:
            return
        with self._lock:
            self.totals[name] += n
            self.counts[name] += 1
            self.counters.add(name)

    def summary(self) -> str:
        lines = ["stage                          total_s   calls    ms/call"]
        stages = ((name, total) for name, total in self.totals.items()
                  if name not in self.counters)
        for name, total in sorted(stages, key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<30} {total:8.3f} {n:7d} {1000 * total / n:10.2f}"
            )
        if self.counters:
            lines.append("counter                          total   calls")
            for name in sorted(self.counters):
                lines.append(f"{name:<30} {self.totals[name]:8.0f} "
                             f"{self.counts[name]:7d}")
        return "\n".join(lines)

    def report(self) -> None:
        if self.enabled and self.totals:
            print(self.summary())


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a ``torch.profiler`` trace (CPU and, when a card is present,
    CUDA activity) into ``log_dir/trace.json``. Every thread's spans are
    recorded where the installed torch can follow threads it did not start
    the profiler on; elsewhere only the calling thread's."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        from torch.profiler import _ExperimentalConfig

        options = {"experimental_config":
                   _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):  # a torch without the option
        options = {}
    with profile(activities=activities, **options) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
