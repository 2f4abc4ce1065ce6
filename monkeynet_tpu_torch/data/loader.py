"""Threaded, bounded batch loader and the feeder that stages batches on the card.

Counterpart of monkeynet_tpu/data/loader.py: `collate`, `quantize_feed` and
`DataLoader` are copies (with the shard options of data-parallel
training), so the port sees the JAX package's batches
exactly (the shuffle keyed by (seed, epoch), the
per-item RNG by (seed, epoch, batch, global position), one persistent worker pool
across epochs, and at most `prefetch + num_workers - 1` decoded batches in
flight: a semaphore gates
workers before they claim a task, so the in-flight set is always the
lowest-indexed pending batches). `DevicePrefetch` takes the place of the JAX
package's `device_prefetch`: a feeder thread copies batch N+1 to the card
from pinned memory on a CUDA stream of its own while step N runs.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from monkeynet_tpu_torch.utils.tracing import span


def collate(items):
    """Stack a list of dict samples into batched numpy arrays."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def quantize_feed(batch, keys=("source", "video")):
    """Re-quantize float [0,1] image arrays to uint8 for the device feed
    (4x less host->device traffic; `Trainer.step` rescales on the device).

    Runs inside loader workers (DataLoader postprocess) so the consumer
    thread — whose only job is dispatching device steps — never does
    per-batch numpy passes."""
    out = dict(batch)
    for k in keys:
        if k in out:
            out[k] = (np.clip(out[k], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return out


class DataLoader:
    """Batches of `dataset`. The defaults are the train loop's walk:
    shuffled every epoch, the last partial batch dropped. `shuffle=False,
    drop_last=False` walks in order and keeps the last partial batch (the
    keypoint predictor's windows).

    batch_size is the local batch. With num_shards > 1 (data-parallel
    training, one shard a rank) every shard walks the same seed-keyed
    permutation and takes its contiguous slab, shard_index * batch_size
    onward, of each global batch of num_shards * batch_size, so the union
    of the shards' batches is the single-process global batch exactly;
    `len` counts global batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
        postprocess=None,
    ):
        if num_shards > 1 and not drop_last:
            raise ValueError("sharded loading requires drop_last=True")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.num_shards = num_shards
        self.shard_index = shard_index
        # Applied to each collated batch INSIDE the worker thread (e.g.
        # quantize_feed): batch-level numpy work belongs with decode/augment,
        # not on the consumer thread that keeps the device queue full.
        self.postprocess = postprocess
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        global_bs = self.batch_size * self.num_shards
        return n // global_bs if self.drop_last else -(-n // global_bs)

    def _batch_indices(self, epoch: int):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        global_bs = self.batch_size * self.num_shards
        stop = (n // global_bs) * global_bs if self.drop_last else n
        for i in range(0, stop, global_bs):
            lo = i + self.shard_index * self.batch_size
            yield order[lo : lo + self.batch_size]

    def _load_batch(self, epoch: int, bi: int, idxs) -> dict:
        items = []
        for pos, j in enumerate(idxs):
            # Per-item RNG: keyed by (seed, epoch, batch, global position),
            # so the augmentation stream of one item never depends on its
            # batchmates, on which worker thread decoded it, or on how the
            # global batch is sharded.
            gpos = self.shard_index * self.batch_size + pos
            rng = np.random.default_rng((self.seed, epoch, bi, gpos))
            try:
                items.append(self.dataset.__getitem__(int(j), rng=rng))
            except TypeError:
                items.append(self.dataset[int(j)])
        batch = collate(items)
        if self.postprocess is not None:
            batch = self.postprocess(batch)
        return batch

    def __iter__(self) -> Iterator[dict]:
        """One epoch at self.epoch (then bumps it): a 1-epoch stream()."""
        return (batch for _, batch in self.stream(1))

    def stream(self, num_epochs: int) -> Iterator[tuple]:
        """Yield (epoch, batch) across `num_epochs` epochs starting at
        self.epoch, with ONE persistent worker pool.

        Workers prefetch straight across epoch boundaries — on recipes with
        few steps per epoch (actions: ONE) a per-epoch pool would pay thread
        startup and a cold pipeline on every epoch, which measured as the
        dominant train-loop overhead once the step itself got fast. Batch
        content is identical to per-epoch iteration: the shuffle is keyed by
        (seed, epoch) and per-item RNG by (seed, epoch, batch, position),
        both independent of pool lifetime."""
        start = self.epoch
        epoch_batches = [
            (ep, list(self._batch_indices(ep)))
            for ep in range(start, start + num_epochs)
        ]
        self.epoch = start + num_epochs
        total = sum(len(b) for _, b in epoch_batches)
        if total == 0:
            return iter(())

        task_q: "queue.Queue" = queue.Queue()
        for ep, batches in epoch_batches:
            for bi, idxs in enumerate(batches):
                task_q.put((ep, bi, idxs))

        results: dict = {}
        cond = threading.Condition()
        stop_flag = threading.Event()
        # Workers acquire a slot BEFORE claiming a task: the slot holders are
        # therefore exactly the lowest-indexed pending batches, so the batch
        # the consumer is waiting on is always among the ones being decoded.
        # Sized so all workers can decode concurrently while `prefetch`
        # finished batches wait; total in-flight memory stays bounded.
        slots = threading.Semaphore(self.prefetch + self.num_workers - 1)

        def worker():
            while not stop_flag.is_set():
                while not slots.acquire(timeout=0.25):
                    if stop_flag.is_set():
                        return
                try:
                    ep, bi, idxs = task_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = self._load_batch(ep, bi, idxs)
                except Exception as e:  # surface errors to the consumer
                    batch = e
                with cond:
                    results[(ep, bi)] = batch
                    cond.notify_all()

        num_threads = min(self.num_workers, total)

        def gen():
            # Workers start lazily on first next(): an iterator that is
            # created but never advanced spawns no threads (and therefore
            # leaks none — stop_flag would otherwise never be set).
            for _ in range(num_threads):
                threading.Thread(target=worker, daemon=True).start()
            try:
                for ep, batches in epoch_batches:
                    for bi in range(len(batches)):
                        with cond:
                            while (ep, bi) not in results:
                                cond.wait()
                            batch = results.pop((ep, bi))
                        slots.release()  # consumed: a worker starts the next
                        if isinstance(batch, Exception):
                            raise batch
                        yield ep, batch
            finally:
                stop_flag.set()
                with cond:
                    cond.notify_all()

        return gen()


_END = object()


class DevicePrefetch:
    """Stage the batches of a `(epoch, batch)` stream on `device` ahead of
    the consumer; iterate it for `(epoch, host batch, device tensors)`.

    A feeder thread pulls each batch, turns its `keys` into tensors on
    `device` and queues the result up to `depth` batches ahead. On a CUDA
    device the copy goes from pinned host memory, `non_blocking`, on a CUDA
    stream of the feeder's own, and an event is recorded after it. The
    consumer's stream waits on that event before the batch is yielded, and
    every staged tensor is recorded on the consumer's stream: the caching
    allocator would otherwise count the tensor's memory as the copy
    stream's, and could hand it to the next batch's copy while a step on
    the consumer's stream still reads it.

    `wait_s` sums the seconds the consumer spent blocked on the queue: the
    time the loop waited on the loader. Exceptions from the stream or the
    copy re-raise in the consumer; abandoning the iterator stops the feeder
    and closes the stream.
    """

    def __init__(self, stream, device, keys=("source", "video"), depth: int = 2):
        self.stream = stream
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.keys = tuple(keys)
        self.wait_s = 0.0
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, batch, copy_stream):
        host = {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in self.keys}
        if copy_stream is None:
            return host, None
        with torch.cuda.stream(copy_stream):
            staged = {k: v.pin_memory().to(self.device, non_blocking=True)
                      for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return staged, ready

    def _feed(self):
        try:
            copy_stream = None
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                copy_stream = torch.cuda.Stream(self.device)
            try:
                for ep, batch in self.stream:
                    if not self._put((ep, batch, *self._stage(batch, copy_stream), None)):
                        return
            finally:
                close = getattr(self.stream, "close", None)
                if close is not None:
                    close()
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer thread
            self._put((None, None, None, None, e))
            return
        self._put(_END)

    def __iter__(self):
        thread = threading.Thread(target=self._feed, daemon=True, name="monkeynet-feeder")
        thread.start()
        try:
            while True:
                with span("loop.feed_wait"):
                    t0 = time.perf_counter()
                    item = self._q.get()
                    self.wait_s += time.perf_counter() - t0
                if item is _END:
                    return
                ep, batch, staged, ready, err = item
                if err is not None:
                    raise err
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for t in staged.values():
                        t.record_stream(consumer)
                yield ep, batch, staged
        finally:
            self._stop.set()
