"""The traced run's instruments and their reduction to numbers.

- :class:`DeviceTrace`: ``torch.profiler`` (CPU and CUDA activity) around
  the measured window. Its raw events are reduced to the seconds in which
  any operation ran on the device (the union of kernel, copy and fill
  intervals), device time and launch count by kernel name, and the idle
  gaps on the device, each named by the innermost host operation running
  at its midpoint.
- :class:`QuietTimer`: the port's own ``StageTimer`` switched on for the
  run, without its printed table.
"""

from __future__ import annotations

import bisect
import time

import torch

IDLE_GAP_MIN_S = 10e-6  # shorter gaps are launch spacing, not idle time
BREAKDOWN_ENTRIES = 10
NO_HOST_OP = "host: no op recorded"
HOST_LOOKBACK = 4096  # host ops searched back from a gap's midpoint


def _span(e) -> tuple[int, int]:
    """``(start_ns, end_ns)`` of a kineto event."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.end_ns()
    start = int(e.start_us() * 1000)
    return start, start + int(e.duration_us() * 1000)


def merge(intervals) -> list[list[int]]:
    """Sorted, overlapping ``(start, end)`` pairs merged into disjoint
    ones."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(device, host, t0_ns: int, t1_ns: int) -> dict:
    """Numbers of one traced window ``[t0_ns, t1_ns]``: ``device`` and
    ``host`` are ``(name, start_ns, end_ns)`` triples of device operations
    and host operations. Returns ``busy_s``, ``window_s``, ``kernels``
    (``{name: [seconds, launches]}``), ``device_ops`` (the longest names)
    and ``idle_gaps`` (idle seconds by host operation)."""
    device = [(n, max(a, t0_ns), min(b, t1_ns)) for n, a, b in device
              if b > t0_ns and a < t1_ns]
    kernels: dict[str, list] = {}
    for name, a, b in device:
        acc = kernels.setdefault(name, [0.0, 0])
        acc[0] += (b - a) / 1e9
        acc[1] += 1
    busy = merge((a, b) for _, a, b in device)
    busy_s = sum(b - a for a, b in busy) / 1e9
    edges = [t0_ns] + [t for iv in busy for t in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if (edges[i + 1] - edges[i]) / 1e9 >= IDLE_GAP_MIN_S]
    host = sorted(host, key=lambda h: h[1])
    starts = [s for _, s, _ in host]
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        key = NO_HOST_OP
        # the latest-starting host op that still runs at the midpoint
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid)
                           - 1 - HOST_LOOKBACK), -1):
            if host[i][2] >= mid:
                key = host[i][0]
                break
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy_s,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "kernels": kernels,
        "device_ops": [[n, v[0]] for n, v in top[:BREAKDOWN_ENTRIES]],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES],
    }


class DeviceTrace:
    """``with DeviceTrace() as tr: ...`` profiles the body; ``tr.summary``
    is :func:`reduce_events` of it, over the body's wall-clock interval
    (ending after a synchronize)."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1_ns = time.time_ns()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            a, b = _span(e)
            (device if e.device_type() == cuda else host).append(
                (e.name(), a, b))
        # the profiler stamps its events with the wall clock's nanoseconds
        self.summary = reduce_events(device, host, self.t0_ns, t1_ns)
        return False


def quiet_timer():
    """The port's ``StageTimer``, on, with its end-of-stream table
    silenced."""
    from sykepic_tpu_torch.utils.profiling import StageTimer

    class QuietTimer(StageTimer):
        def report(self) -> None:
            pass

    return QuietTimer(enabled=True)
