"""The train loop: batches or augmentation plans in, k steps a dispatch,
logging, checkpoints, resume.

Counterpart of `train` in monkeynet_tpu/tasks/train_loop.py, with the
reference train() capabilities (train.py:78-155): three Adam optimizers with
a MultiStep schedule, resume from a checkpoint, a log line of running means
every `log_freq_iter` steps with a train-vis gif, and epoch checkpoints.

The config's keys decide the path, with the JAX package's defaults:
- `steps_per_dispatch` (32): k = the largest divisor of the run's step count
  that is at most this, and `Trainer.run` takes k steps a dispatch: on the
  card, replays of the step captured in a CUDA graph. k = 1 takes eager
  steps.
- `device_feed`: the train split decoded once into a uint8 cache on the
  card (data/device_feed.py), and each step's batch made there from the
  host's augmentation plans. Over the memory budget
  (`device_feed_hbm_gb`, default half the card) the run takes the host
  feed and says so.
- otherwise the host feed: the threaded loader's batches, a chunk of k
  stacked at a time.
A feeder thread builds chunk N+1 and copies it to the card while chunk N
runs. A dispatch is cut short where a checkpoint is due (at the end of its
epoch, so the checkpoint holds that epoch's state exactly) and where the
profiled steps begin and end.

Resume follows the reference and the JAX package: a checkpoint holds the
epoch that last finished and the last logged iteration, and the resumed run
starts at that epoch, so it trains that epoch again
(tests/test_e2e.py::test_resume_from_checkpoint pins this in the JAX package).
The checkpoint may be the port's or the reference's `.pth.tar` or the JAX
package's `.msgpack` (utils/checkpoint.py `load_any`); the iteration count
goes on from the file's `it`.

Data parallelism (`num_devices` > 1, or a process `group`): one process a
device, each loading only its slab of every global batch (the loader and
`plan_stream` sharded, the item generators keyed by the global position)
and taking the global-batch step (tasks/train.py `Trainer` with the group).
Under torchrun the call joins the group its environment describes;
otherwise it spawns the ranks itself on the first N cards (NCCL), or on the
CPU (gloo) for device='cpu'. Every rank draws the same initial weights from
the seed, and one all-reduced checksum checks that the replicas agree. Rank
0 alone writes log.txt, the train-vis gifs (of the whole global batch,
gathered from the ranks) and the checkpoints; since the state is
replicated, a checkpoint of any world size resumes into any other.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from monkeynet_tpu_torch.data.device_feed import (
    PLAN_KEYS,
    CacheOverBudget,
    build_video_cache,
    cache_budget_bytes,
    make_device_augment,
    padding_overhead,
    plan_stream,
)
from monkeynet_tpu_torch.data.loader import DataLoader, DevicePrefetch, quantize_feed
from monkeynet_tpu_torch.parallel.distributed import (
    all_gather_cat,
    all_reduce_,
    group_rank,
    group_size,
    maybe_initialize_distributed,
    spawn,
)
from monkeynet_tpu_torch.parallel.mesh import local_devices
from monkeynet_tpu_torch.tasks.animate import split_kp
from monkeynet_tpu_torch.tasks.build import build_train_models
from monkeynet_tpu_torch.tasks.train import Trainer, largest_divisor_leq, metric_names
from monkeynet_tpu_torch.utils.checkpoint import load_any
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.logger import Logger

# torch.profiler covers these steps when `profile_dir` is given, as the JAX
# package's trace does.
PROFILE_STEPS = (10, 20)


@dataclasses.dataclass
class TrainRun:
    """What `train` returns: the trainer after the last step, the epochs and
    steps this call trained, the loop's wall seconds (first batch to the last
    step's end, synchronised), and the seconds it waited on the feeder.
    Then how it ran: the steps a dispatch, whether the device feed ran, its
    cache's bytes on the card and the seconds it took to build them (decode
    and copy), and the last step's losses (in `metric_names` order)."""

    trainer: Trainer
    epochs: List[int]
    steps: int
    wall_s: float
    loader_wait_s: float
    steps_per_dispatch: int = 1
    device_feed: bool = False
    cache_bytes: int = 0
    cache_s: float = 0.0
    last_metrics: Optional[torch.Tensor] = None


def train(config, log_dir, dataset, checkpoint=None, seed=0, num_devices=1,
          profile_dir=None, device="cuda", group=None) -> TrainRun:
    """Train the three networks of `config` on `dataset` for
    `train_params.num_epochs` epochs (less the epochs a checkpoint has
    done), logging and checkpointing into `log_dir`. Runs on the card unless
    `device` says otherwise.

    num_devices > 1 trains data-parallel over that many ranks: under
    torchrun this process is one of them; otherwise the call spawns them
    and returns rank 0's run without its trainer (its state is in the
    checkpoints). `group`: the process group this process is a rank of
    (this rank's device is `device`); a group of one rank takes the sharded
    path too."""
    device = require_device(device)
    train_params = config["train_params"]
    batch_size = train_params["batch_size"]
    if num_devices > 1 and batch_size % num_devices:
        raise ValueError(f"batch_size {batch_size} must be divisible by num_devices "
                         f"{num_devices} for data-parallel training")
    if group is None and maybe_initialize_distributed():
        group = dist.group.WORLD
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if group is None and num_devices > 1:
        devices = local_devices(num_devices, device)
        runs = spawn(_train_rank, devices, "gloo" if device.type == "cpu" else "nccl",
                     args=(config, log_dir, dataset, checkpoint, seed, profile_dir))
        return runs[0]
    rank, world = group_rank(group), group_size(group)
    if num_devices > 1 and num_devices != world:
        raise ValueError(f"num_devices {num_devices}, but the process group has {world} ranks")
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must be divisible by the {world} ranks of "
                         "the process group")
    image_shape = tuple(config["dataset_params"].get("image_shape", (64, 64, 3)))

    # uint8 feed: quantized in the loader workers, rescaled by the step on
    # the card (4x fewer bytes to copy).
    feed_uint8 = train_params.get("feed_dtype", "float32") == "uint8"
    loader = DataLoader(
        dataset,
        batch_size=batch_size // world,
        num_workers=int(train_params.get("num_workers", 2)),
        seed=seed,
        num_shards=world,
        shard_index=rank,
        postprocess=quantize_feed if feed_uint8 else None,
    )
    steps_per_epoch = max(1, len(loader))
    trainer = Trainer(build_train_models(config, device=device, seed=seed),
                      train_params, device=device, steps_per_epoch=steps_per_epoch,
                      group=group)
    if group is not None:
        _check_replicas(trainer, group)
    if rank != 0:
        profile_dir = None

    start_epoch, it = 0, 0
    if checkpoint is not None:
        loaded = load_any(checkpoint, group=group)
        trainer.load_state_dict(loaded)
        start_epoch = int(loaded.get("epoch", 0))
        it = int(loaded.get("it", 0))
        # The shuffle and the per-item augmentation RNG are keyed by (seed,
        # epoch): start the stream at the restored epoch.
        loader.epoch = start_epoch

    num_epochs = train_params["num_epochs"] - start_epoch
    total_steps = max(1, num_epochs * steps_per_epoch)
    k = largest_divisor_leq(total_steps, int(train_params.get("steps_per_dispatch", 32)))
    # The loader keeps two chunks in flight, so that the feeder takes the
    # next chunk from a warm buffer while the card runs this one.
    loader.prefetch = max(loader.prefetch, 2 * k)

    feed = (_device_feed(train_params, dataset, image_shape, device)
            if train_params.get("device_feed", False) else None)
    if feed is not None:
        augment, lengths, cache_bytes, cache_s = feed
        stream = plan_stream(dataset, dataset.transform, lengths, batch_size // world,
                             seed, start_epoch, num_epochs, num_shards=world, shard_index=rank)
        keys = PLAN_KEYS
    else:
        augment, cache_bytes, cache_s = None, 0, 0.0
        stream = loader.stream(num_epochs)
        keys = ("source", "video")

    names = metric_names(train_params)
    log_params = dict(train_params.get("log_params", {}))
    chunks = DevicePrefetch(_chunked(stream, k, keys), device, keys=keys)
    profiler = None
    epochs, steps, last_metrics = [], 0, None
    t0 = time.perf_counter()
    with Logger(log_dir=log_dir, visualizer_params=config.get("visualizer_params"),
                write=rank == 0, **log_params) as logger:
        epoch_steps = 0
        last_finished = start_epoch - 1
        payload = trainer.state_dict  # called only when a checkpoint is written
        for eps, host, staged in chunks:
            for ep in eps:
                if not epochs or epochs[-1] != ep:
                    epochs.append(ep)
            cuts = _cuts(eps, it, epoch_steps, steps_per_epoch, logger.cpk_freq,
                         PROFILE_STEPS if profile_dir else ())
            for a, b in zip(cuts[:-1], cuts[1:]):
                if profile_dir and profiler is None and it >= PROFILE_STEPS[0]:
                    profiler = _start_profiler(device)
                vis_steps = [j for j in range(a, b) if (it + j - a) % logger.log_freq == 0]
                metrics, visuals = trainer.run(staged, a, b, vis_steps, augment=augment,
                                               graph=k > 1)
                logger.stage_payload(payload)
                if profiler is not None and it + b - a > PROFILE_STEPS[1]:
                    _stop_profiler(profiler, device, profile_dir)
                    profile_dir = None
                    profiler = None
                last_metrics = metrics[-1]
                logger.log_chunk(
                    it, names, metrics, b - a,
                    vis=lambda j, a=a, host=host, visuals=visuals: _vis(
                        None if augment is not None else host, a + j, visuals[a + j], group),
                )
                metrics = visuals = None
                it += b - a
                steps += b - a
                epoch_steps += b - a
                if epoch_steps >= steps_per_epoch:
                    # One or more epochs ended in this stretch; the
                    # checkpoint, if one is due, holds its end state.
                    epoch_steps %= steps_per_epoch
                    finished = eps[b - 1 - epoch_steps]
                    logger.log_epoch(finished, payload, prev_epoch=last_finished)
                    last_finished = finished
        if profiler is not None:  # the run ended inside the profiled steps
            _stop_profiler(profiler, device, profile_dir)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
    if group is not None:  # rank 0's files are complete when any rank returns
        dist.barrier(group=group)
    return TrainRun(trainer, epochs, steps, wall_s, chunks.wait_s, steps_per_dispatch=k,
                    device_feed=feed is not None, cache_bytes=cache_bytes, cache_s=cache_s,
                    last_metrics=last_metrics)


def _train_rank(rank, world, device, config, log_dir, dataset, checkpoint, seed, profile_dir):
    """One rank of a spawned data-parallel train(): its run, without the
    trainer and with the last metrics on the CPU."""
    run = train(config, log_dir, dataset, checkpoint=checkpoint, seed=seed, num_devices=world,
                profile_dir=profile_dir, device=device, group=dist.group.WORLD)
    last = None if run.last_metrics is None else run.last_metrics.cpu()
    return dataclasses.replace(run, trainer=None, last_metrics=last)


@torch.no_grad()
def _check_replicas(trainer, group) -> None:
    """Raise unless every rank holds the same initial state: one all-reduce
    (max) of [checksum, -checksum] over the group, so max == min."""
    flat = torch.cat([t.detach().double().reshape(-1) for model in trainer.models.values()
                      for t in model.state_dict().values() if t.is_floating_point()])
    where = torch.arange(flat.numel(), device=flat.device, dtype=torch.float64) / flat.numel()
    sums = torch.stack([flat.sum(), (flat * flat).sum(), (flat * where).sum()])
    both = all_reduce_(torch.cat([sums, -sums]), group, op=dist.ReduceOp.MAX).cpu()
    if not torch.equal(both[:3], -both[3:]):
        raise RuntimeError(f"data-parallel train: the ranks' initial weights differ (checksums "
                           f"from {(-both[3:]).tolist()} to {both[:3].tolist()})")


def _device_feed(train_params, dataset, image_shape, device):
    """(augment, lengths, cache bytes, cache seconds) of the device feed:
    the plan executor bound to the video cache on `device`, and the videos'
    lengths; or None, after saying why, where the cache is over budget."""
    transform = dataset.transform
    if not (hasattr(transform, "supports_device_feed")
            and transform.supports_device_feed(image_shape[0], image_shape[1])):
        raise ValueError(
            "device_feed: true requires an augmentation pipeline with an exact on-device "
            "formulation (nearest resize with ratio > ~0.8 so the anti-alias prefilter "
            "stays identity); use the host feed for this config"
        )
    budget = cache_budget_bytes(train_params, device)
    t0 = time.perf_counter()
    try:
        videos_np, lengths = build_video_cache(dataset, budget_bytes=budget)
    except CacheOverBudget as e:
        print(f"WARNING: device_feed disabled — {e}; set train_params.device_feed_hbm_gb "
              "to raise the budget, or leave the host feed (this run) for datasets larger "
              "than the card's memory")
        return None
    padded, real = padding_overhead(lengths, image_shape)
    if padded > 1.5 * real:
        print(f"device_feed: Tmax padding overhead {padded / real:.2f}x "
              f"({padded / 2**30:.2f} GiB padded vs {real / 2**30:.2f} GiB of real frames)")
    videos = torch.from_numpy(videos_np).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cache_s = time.perf_counter() - t0
    execute = make_device_augment(transform, image_shape)

    def augment(plan):
        return execute(videos, plan)

    return augment, lengths, videos.numel(), cache_s


def _chunked(stream, k: int, keys):
    """Group an (epoch, batch) stream into (epochs, {key: (k, ...) stack})
    chunks of k steps. Runs on the feeder thread."""
    try:
        eps, buf = [], []
        for ep, batch in stream:
            eps.append(ep)
            buf.append(batch)
            if len(buf) == k:
                yield eps, {key: np.stack([b[key] for b in buf]) for key in keys}
                eps, buf = [], []
        if buf:  # k divides the run's step count, so this stays empty
            yield eps, {key: np.stack([b[key] for b in buf]) for key in keys}
    finally:
        close = getattr(stream, "close", None)
        if close is not None:
            close()


def _cuts(eps, it: int, epoch_steps: int, steps_per_epoch: int, cpk_freq: int, profile=()):
    """Where to cut a chunk of len(eps) steps into dispatches: after a step
    that ends an epoch with a checkpoint due, and where the profiled steps
    begin and end."""
    n = len(eps)
    cuts = {0, n}
    for j, ep in enumerate(eps):
        if (epoch_steps + j + 1) % steps_per_epoch == 0 and ep % cpk_freq == 0:
            cuts.add(j + 1)
    for edge in (profile[0] - it, profile[1] + 1 - it) if profile else ():
        if 0 < edge < n:
            cuts.add(edge)
    return sorted(cuts)


def _vis(host, j: int, out, group=None):
    """The train-vis gif's inputs as numpy in [0, 1] and the step's outputs
    with the keypoints split into source and driving. The inputs are step
    j of the host chunk (a uint8 feed undone), or with the device feed
    (`host` None) the augmented batch the step made on the card. With a
    process group, every rank calls it and each array is the global batch,
    gathered from the ranks' slabs. Called at log boundaries only: it waits
    on the card."""
    device = out["video_prediction"].device
    if host is None:
        inp = {k: out[k] for k in ("source", "video")}
    else:
        inp = {k: torch.from_numpy(host[k][j].astype("float32") / 255.0
                                   if host[k].dtype == "uint8" else host[k][j])
               for k in ("source", "video")}

    def fetch(t):
        t = t.float()
        if group is not None:
            t = all_gather_cat(t.to(device), group)
        return t.cpu().numpy()

    kps = split_kp(out["kp_joined"], False)
    inp = {k: fetch(v) for k, v in inp.items()}
    vis_out = {k: fetch(out[k]) for k in ("video_prediction", "video_deformed")}
    for name, kp in kps.items():
        vis_out[name] = {k: fetch(v) for k, v in kp.items()}
    return inp, vis_out


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device, profile_dir):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "train_trace.json"))
