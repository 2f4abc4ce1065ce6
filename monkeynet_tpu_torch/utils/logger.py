"""Training logger: running-mean loss lines, train-vis gifs, checkpoints.

Counterpart of monkeynet_tpu/utils/logger.py, with the reference Logger's
capabilities (logger.py:11-88): `log.txt` lines with a zero-filled iteration
counter and the running means of the named losses every `log_freq_iter`,
plus the steps/s since the previous line; train-vis reconstruction gifs;
checkpoint files every `cpk_freq_epoch` epochs and on exit.

The loss values of each step stay on the device until a log boundary, where
they come to the host in one copy: the loop never waits on the card between
boundaries.

In data-parallel training every rank keeps a Logger, and only one (rank 0)
is told to write (`write=True`); the others keep its count of iterations
and epochs, write no file, and still call the `vis` callables at the log
boundaries, since those gather the ranks' samples.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from monkeynet_tpu_torch.data.io import write_gif
from monkeynet_tpu_torch.utils.async_write import AsyncWriter
from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, save_checkpoint
from monkeynet_tpu_torch.utils.visualizer import Visualizer


class Logger:
    def __init__(
        self,
        log_dir: str,
        log_file_name: str = "log.txt",
        log_freq_iter: int = 100,
        cpk_freq_epoch: int = 100,
        zfill_num: int = 8,
        visualizer_params: Optional[dict] = None,
        write: bool = True,
    ):
        self.loss_list: List = []
        self.write = write
        self.cpk_dir = log_dir
        self.visualizations_dir = os.path.join(log_dir, "train-vis")
        self.log_file = None
        if write:
            os.makedirs(self.visualizations_dir, exist_ok=True)
            self.log_file = open(os.path.join(log_dir, log_file_name), "a")
        self.log_freq = log_freq_iter
        self.cpk_freq = cpk_freq_epoch
        self.zfill_num = zfill_num
        self.visualizer = Visualizer(**(visualizer_params or {}))
        self.epoch = 0
        self.it = 0
        self.payload = None
        self._t_last = time.time()
        self._steps_since_log = 0
        # Train-vis gifs rasterize and encode on a background thread, spawned
        # at the first gif and joined at __exit__, so the gifs are on disk
        # when the loop returns.
        self._writer = None

    # ---------------------------------------------------------------- scores
    def log_scores(self, loss_names):
        if not self.write:
            self.loss_list = []
            self._steps_since_log = 0
            return
        # One device-to-host copy for all the steps since the last line:
        # rows lo .. hi - 1 of each chunk's (k, M) stack.
        rows = torch.cat([torch.as_tensor(values)[lo:hi]
                          for values, lo, hi in self.loss_list]).cpu().numpy()
        loss_mean = rows.mean(axis=0)
        elapsed = time.time() - self._t_last
        sps = self._steps_since_log / elapsed if elapsed > 0 else float("nan")
        parts = "; ".join(
            f"{name} - {value:.5f}" for name, value in zip(loss_names, loss_mean)
        )
        line = f"{str(self.it).zfill(self.zfill_num)}) {parts}; steps/s - {sps:.3f}"
        print(line, file=self.log_file)
        self.log_file.flush()
        self.loss_list = []
        self._t_last = time.time()
        self._steps_since_log = 0

    def visualize_rec(self, inp, out):
        """inp / out: numpy, as Visualizer.visualize_reconstruction takes them."""
        path = os.path.join(
            self.visualizations_dir, f"{str(self.it).zfill(self.zfill_num)}-rec.gif"
        )

        def job(inp=inp, out=out, path=path):
            write_gif(path, self.visualizer.visualize_reconstruction(inp, out))

        if self._writer is None:
            self._writer = AsyncWriter(name="monkeynet-logger-vis")
        self._writer.submit(job)

    # ----------------------------------------------------------- checkpoints
    def stage_payload(self, payload):
        """Stage the checkpoint payload (dict or zero-arg callable) without
        writing; the next save_cpk / exit checkpoint uses it."""
        self.payload = payload

    def save_cpk(self, is_exit: bool = False):
        if self.payload is None or not self.write:
            return
        # The payload may be a zero-arg callable: the loop passes one, so the
        # state is copied to the host only on epochs that checkpoint.
        if is_exit:
            try:
                payload = self.payload() if callable(self.payload) else self.payload
            except Exception as e:  # pragma: no cover - emergency-save path
                # Losing the emergency checkpoint must not mask the error the
                # loop is unwinding with. Scheduled epoch checkpoints get no
                # such net: a failure to serialize there raises.
                print(f"warning: checkpoint payload unavailable, skipping ({e})")
                return
        else:
            payload = self.payload() if callable(self.payload) else self.payload
        payload = dict(payload)
        payload["epoch"] = self.epoch
        payload["it"] = self.it
        path = os.path.join(self.cpk_dir, checkpoint_name(self.epoch, self.zfill_num))
        save_checkpoint(path, payload)

    # -------------------------------------------------------------- protocol
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self.payload is not None:
            self.save_cpk(is_exit=True)
        if self.log_file is not None:
            self.log_file.close()
        if self._writer is None:
            return
        if exc_type is not None:
            # Don't mask the loop's exception with a writer failure; still
            # drain so queued gifs land on disk.
            try:
                self._writer.close()
            except Exception as e:
                print(f"warning: train-vis writer failed during unwind ({e})")
        else:
            self._writer.close()

    def log_iter(self, it: int, names, values, vis: Optional[Callable] = None):
        """Record step `it`'s loss `values` (a tensor, on the device is fine;
        it is not read until the next log boundary). At a boundary, writes
        the line and, when `vis` is given, the gif of `vis() -> (inp, out)`,
        which is called there and only there."""
        self.log_chunk(it, names, torch.as_tensor(values)[None], 1,
                       vis=None if vis is None else lambda j: vis())

    def log_chunk(self, it0: int, names, values, nsteps: int, vis: Optional[Callable] = None):
        """Record the (nsteps, M) loss `values` of steps it0 .. it0 +
        nsteps - 1 (on the device is fine). Writes exactly the lines that
        `log_iter` would write step by step: one at each iteration divisible
        by log_freq, over the running mean of the rows since the line
        before; at each, the gif of `vis(j) -> (inp, out)` for the chunk's
        step j, called there and only there."""
        end = it0 + nsteps
        cursor = 0
        boundary = -(-it0 // self.log_freq) * self.log_freq  # the first >= it0
        while boundary < end:
            j = boundary - it0
            self.loss_list.append((values, cursor, j + 1))
            self._steps_since_log += j + 1 - cursor
            cursor = j + 1
            self.it = boundary
            self.log_scores(names)
            if vis is not None:
                drawn = vis(j)
                if self.write:
                    self.visualize_rec(*drawn)
            boundary += self.log_freq
        if cursor < nsteps:
            self.loss_list.append((values, cursor, nsteps))
            self._steps_since_log += nsteps - cursor
        self.it = end - 1

    def log_epoch(self, epoch: int, payload, prev_epoch: Optional[int] = None):
        """payload: checkpoint dict, or a zero-arg callable returning one
        (called only when a checkpoint is written).

        With `prev_epoch` (a dispatch of several steps can finish several
        epochs), the checkpoint is written if any epoch in (prev_epoch,
        epoch] is due, so that a chunk never skips a scheduled one; it is
        labelled `epoch`."""
        self.epoch = epoch
        self.payload = payload
        lo = epoch if prev_epoch is None else prev_epoch + 1
        if any(e % self.cpk_freq == 0 for e in range(lo, epoch + 1)):
            self.save_cpk()
