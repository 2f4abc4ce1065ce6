"""Background artifact writer: gif/png rasterize+encode off the hot thread.

Counterpart of monkeynet_tpu/utils/async_write.py. The reference writes its
train-vis gifs synchronously inside the loop (reference logger.py:40-47), so
the encode blocks the thread that launches the card's work, and a gif at a
log boundary is charged to the next log window.

AsyncWriter runs queued zero-arg jobs on ONE daemon worker thread so
rasterization and encoding overlap the next steps. Ordering is preserved
(single worker, FIFO queue), backpressure is bounded (a small queue; submit
blocks when the encoder falls behind rather than buffering unbounded pixel
arrays), and failures are never silent: a job's exception is re-raised on
the next submit() or at close(). close() drains the queue and joins the
thread: callers flush before reading the artifacts or exiting.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class AsyncWriter:
    def __init__(self, maxsize: int = 4, name: str = "monkeynet-writer"):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                if self._exc is None:  # fail fast: skip queued work after an error
                    job()
            except BaseException as e:  # noqa: BLE001 - re-raised on the caller thread
                self._exc = e
            finally:
                self._q.task_done()

    def _reraise(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, job: Callable[[], None]):
        """Queue a zero-arg job. Blocks when the writer is `maxsize` jobs
        behind (backpressure, not unbounded buffering). Raises any exception
        a previous job left behind."""
        if self._closed:
            raise RuntimeError("AsyncWriter is closed")
        self._reraise()
        self._q.put(job)

    def flush(self):
        """Block until every queued job has run; re-raise any job failure."""
        self._q.join()
        self._reraise()

    def close(self):
        """Drain, stop and join the worker; re-raise any job failure.
        Idempotent."""
        if self._closed:
            self._reraise()
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._reraise()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        # Don't let a writer error mask the original exception.
        if exc_type is not None:
            try:
                self.close()
            except Exception:
                pass
        else:
            self.close()
