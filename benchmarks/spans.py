"""Arithmetic over the program's spans in a traced slice.

The program marks its phases with torch.profiler ranges
(monkeynet_tpu_torch/utils/tracing.py) while a profiler runs, so the
benchmark's window holds them among its host events, on the clock of the
device operations and clipped to the window as `trace.Window.records()`
clips every event. A span name may occur many times and nest in itself;
each reader here takes the union of its intervals, and returns None where
the slice holds no span of the name (a program without the span).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmarks import trace


def intervals(records: Dict, name: str) -> List[Tuple[float, float]]:
    """The union of the host intervals named `name`, as sorted disjoint
    (start, end) pairs in seconds from the window's start."""
    out = []
    for _, s, e in sorted(h for h in records["host"] if h[0] == name):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def seconds(records: Dict, name: str) -> Optional[float]:
    """Seconds of the window inside a span named `name`, or None."""
    spans = intervals(records, name)
    return sum(e - s for s, e in spans) if spans else None


def idle_seconds(records: Dict, name: str) -> Optional[float]:
    """Seconds of the window in which the device ran nothing and the host
    was inside a span named `name`, or None."""
    spans = intervals(records, name)
    if not spans:
        return None
    idle = trace.gaps([(s, e) for _, s, e in records["device"]], 0.0, records["window_s"])
    total, i = 0.0, 0
    for s, e in idle:  # both lists sorted and disjoint
        while i < len(spans) and spans[i][1] <= s:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < e:
            total += min(e, spans[j][1]) - max(s, spans[j][0])
            j += 1
    return total
