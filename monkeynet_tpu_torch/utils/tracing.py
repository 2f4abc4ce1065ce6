"""Spans on the profiler's clock.

`span(name)` marks a phase of the program for torch.profiler: while a
profiler runs in the process, it is a RecordFunction range, kept in the
profiler's buffer on the same clock as the device activity, and written
out wherever that profiler's trace goes (`export_chrome_trace`, or a
reader of its events). Without a profiler it is one shared no-op context:
one flag check, nothing allocated, nothing called. The spans keep no clock,
list or exporter of their own.

The range is `torch._C._profiler._RecordFunctionFast`, a host event of the
kind an ATen op records (`cpu_op`), and not `torch.profiler.record_function`,
a user annotation. For a user annotation the CUDA profiler also records a
device-side range over the kernels launched inside it, which a reader of the
device's activity takes for device work where the events do not say their
kind (torch 2.11's do not): a launch-bound taichi transfer, idle ~79% of its
traced slice, then reads ~5% idle. On an H100 host an enter and exit of the
annotation costs ~16 us under the profiler, of this range ~2 us.

The spans, by where they sit:

- tasks/animate.py `TransferEngine.__call__`: `transfer.video` over the
  call, holding `transfer.upload` (the inputs onto the device and the
  source's cast) and one `transfer.chunk` a chunk, which holds
  `transfer.detect`, `transfer.generate` and `transfer.gather`; on a CUDA
  device, one `transfer.deliver` a chunk (`_StagingRing`): the chunk's copy
  into the host answer, inside the next chunk's `transfer.chunk` (the last
  chunk's after them); for frames of 1 MiB or more a host copy out of the
  chunk's pinned staging slot, for smaller ones the copy straight from the
  device into pageable memory;
- tasks/train.py `Trainer.run`: `trainer.run` over the call, holding one
  `trainer.step` a step;
- tasks/train_loop.py `train`: `loop.log` around the logger's staging and
  its chunk's lines, `loop.checkpoint` around an epoch's end;
  data/loader.py `DevicePrefetch`: `loop.feed_wait` around the wait on the
  feeder's queue that `wait_s` sums.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_Range = torch._C._profiler._RecordFunctionFast

# The context every span returns while no profiler runs.
OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a torch profiler runs, else the
    shared no-op context `OFF`."""
    if _profiler._is_profiler_enabled:
        return _Range(name)
    return OFF
