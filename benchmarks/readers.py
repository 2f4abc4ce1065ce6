"""Arithmetic the per-layer metric readers share (benchmarks/metrics/).

Each reader takes the records of a traced run: the trace of the traced slice
(`trace`: device operations and host events in seconds, `window_s`), the
slice's host seconds, the frames or steps it held, the model FLOPs and the
program's kernel bytes that the benchmark computed for that work from the
cell's shapes, counters, and the host seconds and model FLOPs of the run's
measured window, which the profiler does not slow: a traced run profiles a
slice after it (`window_host_s`, `window_model_flops`). A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

from benchmarks import flops, kernels, trace


def device_seconds_by_kind(records: Dict) -> Dict[str, float]:
    out = defaultdict(float)
    for name, s, e in records["trace"]["device"]:
        out[kernels.kind_of(name)] += e - s
    return out


def per_unit(records: Dict, seconds: float, unit: str, scale: float) -> Optional[float]:
    """`seconds` of device time per traced frame or step, times `scale`."""
    count = records.get(f"traced_{unit}")
    if not count:
        return None
    return seconds / count * scale


def kinds_per_unit(records: Dict, kinds, unit: str, scale: float) -> Optional[float]:
    by_kind = device_seconds_by_kind(records)
    return per_unit(records, sum(by_kind.get(k, 0.0) for k in kinds), unit, scale)


def roofline_pct(records: Dict, ops=None) -> Optional[float]:
    """100 x the byte-bound time of the program's kernel operations in the
    slice over their measured time (all of them, or those of `ops`)."""
    ops = set(ops or kernels.OPS.values())
    seconds = 0.0
    for name, s, e in records["trace"]["device"]:
        kernel = kernels.port_kernel(name)
        if kernel and kernels.OPS[kernel] in ops:
            seconds += e - s
    nbytes = sum(b for op, b in records["kernel_bytes"].items() if op in ops)
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / kernels.HBM_BYTES_PER_S / seconds


def mfu_pct(records: Dict) -> Optional[float]:
    """100 x the model FLOPs of the work done in the measured window over
    its host seconds and the card's dense peak in the compute dtype: the
    profiler, which runs after the window, slows none of it."""
    peak = flops.peak(records["device_name"], records["compute_dtype"])
    if peak is None or not records.get("window_host_s"):
        return None
    return 100.0 * records["window_model_flops"] / records["window_host_s"] / peak


def idle_pct(records: Dict) -> Optional[float]:
    window = records["trace"]["window_s"]
    if window <= 0:
        return None
    busy = trace.union([(s, e) for _, s, e in records["trace"]["device"]])
    return 100.0 * (1.0 - busy / window)


def busy_ms_per_step(records: Dict) -> Optional[float]:
    busy = trace.union([(s, e) for _, s, e in records["trace"]["device"]])
    return per_unit(records, busy, "steps", 1e3)
