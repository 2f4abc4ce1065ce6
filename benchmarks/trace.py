"""A torch.profiler window and what the metric readers read from it.

`Window` traces the CPU and the card over a slice of a run, with the
benchmark's span `bench.window` around it. `records()` reduces the trace to
plain data: the device operations (kernels, copies, sets) inside the span,
the host events, and the span's bounds, all in seconds from the span's
start. The interval union and the kinds are the arithmetic of
scripts/profile_torch_port.py, copied here so that the yardstick stays with
the benchmark.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

SPAN = "bench.window"


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, start: float, stop: float) -> List[Tuple[float, float]]:
    """The stretches of [start, stop] that no interval covers."""
    out, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, stop)))
        cursor = max(cursor, e)
        if cursor >= stop:
            break
    if cursor < stop:
        out.append((cursor, stop))
    return [(s, e) for s, e in out if e > s]


class Window:
    """Profile the CPU and CUDA activity between start() and stop()."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self._span = None
        self.host_s = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._span = record_function(SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.host_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def records(self) -> Dict:
        """{'device': [(name, start_s, end_s)], 'host': [(name, start_s,
        end_s)], 'window_s'}: every device operation and host event that
        overlaps the span, clipped to it, times from the span's start."""
        raw = _raw_events(self._prof)
        span = [(s, e) for name, dev, kind, s, e in raw if name == SPAN and not dev]
        if not span:
            raise RuntimeError("the trace holds no benchmark span")
        t0, t1 = span[0]
        device, host = [], []
        for name, dev, kind, s, e in raw:
            if e <= t0 or s >= t1:
                continue
            item = (name, (max(s, t0) - t0) * 1e-9, (min(e, t1) - t0) * 1e-9)
            if dev:
                if "annotation" not in kind and not name.startswith(("Optimizer.", "bench.")):
                    device.append(item)
            elif name != SPAN:
                host.append(item)
        return {"device": device, "host": host, "window_s": (t1 - t0) * 1e-9}


def _raw_events(prof):
    """(name, on_device, activity kind, start_ns, end_ns) of every event."""
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for e in results.events():
            on_device = "cuda" in str(e.device_type()).lower()
            start = e.start_ns()
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            out.append((e.name(), on_device, str(kind).lower(), start, start + e.duration_ns()))
        return out
    for e in prof.events():  # older profilers
        on_device = "cuda" in str(e.device_type).lower()
        out.append((e.name, on_device, "", e.time_range.start * 1000, e.time_range.end * 1000))
    return out


SHORT_GAP_S = 20e-6


def breakdown(records: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle time by
    what the host was doing: the innermost host event over the middle of
    each gap of SHORT_GAP_S or more (shorter gaps, the launch spacing of
    kernels queued back to back, are summed under one label)."""
    by_name = defaultdict(float)
    for name, s, e in records["device"]:
        by_name[name[:160]] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = defaultdict(float)
    host = sorted(records["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    for s, e in gaps([(a, b) for _, a, b in records["device"]], 0.0, records["window_s"]):
        if e - s < SHORT_GAP_S:
            idle["gaps under 20 us"] += e - s
            continue
        mid, label = 0.5 * (s + e), "no host event"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][2] >= mid:
                label = host[i][0][:160]
                break
        idle[label] += e - s
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps_top]}
