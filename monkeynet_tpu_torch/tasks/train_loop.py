"""The train loop: batches in, `Trainer.step`, logging, checkpoints, resume.

Counterpart of `train` in monkeynet_tpu/tasks/train_loop.py, with the
reference train() capabilities (train.py:78-155): three Adam optimizers with
a MultiStep schedule, resume from a checkpoint, a log line of running means
every `log_freq_iter` steps with a train-vis gif, and epoch checkpoints.
Batches come from the threaded loader, and a feeder thread copies batch N+1
to the card while step N runs. The port takes one step per dispatch.

Resume follows the reference and the JAX package: a checkpoint holds the
epoch that last finished and the last logged iteration, and the resumed run
starts at that epoch, so it trains that epoch again
(tests/test_e2e.py::test_resume_from_checkpoint pins this in the JAX package).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List

import torch

from monkeynet_tpu_torch.data.loader import DataLoader, DevicePrefetch, quantize_feed
from monkeynet_tpu_torch.tasks.animate import split_kp
from monkeynet_tpu_torch.tasks.build import build_train_models
from monkeynet_tpu_torch.tasks.train import Trainer, metric_names
from monkeynet_tpu_torch.utils.checkpoint import load_checkpoint
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.logger import Logger

# torch.profiler covers these steps when `profile_dir` is given, as the JAX
# package's trace does.
PROFILE_STEPS = (10, 20)


@dataclasses.dataclass
class TrainRun:
    """What `train` returns: the trainer after the last step, the epochs and
    steps this call trained, the loop's wall seconds (first batch to the last
    step's end, synchronised), and the seconds it waited on the loader."""

    trainer: Trainer
    epochs: List[int]
    steps: int
    wall_s: float
    loader_wait_s: float


def train(config, log_dir, dataset, checkpoint=None, seed=0, num_devices=1,
          profile_dir=None, device="cuda") -> TrainRun:
    """Train the three networks of `config` on `dataset` for
    `train_params.num_epochs` epochs (less the epochs a checkpoint has
    done), logging and checkpointing into `log_dir`. Runs on the card unless
    `device` says otherwise."""
    device = require_device(device)
    if num_devices > 1:
        raise NotImplementedError(
            "data-parallel training is not ported yet (ROADMAP item 5); use num_devices=1"
        )
    train_params = config["train_params"]
    if train_params.get("device_feed", False):
        print("device_feed: the port takes the host feed; the device feed is ROADMAP item 3")

    # uint8 feed: quantized in the loader workers, rescaled by Trainer.step
    # on the card (4x fewer bytes to copy).
    feed_uint8 = train_params.get("feed_dtype", "float32") == "uint8"
    loader = DataLoader(
        dataset,
        batch_size=train_params["batch_size"],
        num_workers=int(train_params.get("num_workers", 2)),
        seed=seed,
        postprocess=quantize_feed if feed_uint8 else None,
    )
    steps_per_epoch = max(1, len(loader))
    trainer = Trainer(build_train_models(config, device=device, seed=seed), train_params,
                      device=device, steps_per_epoch=steps_per_epoch)

    start_epoch, it = 0, 0
    if checkpoint is not None:
        loaded = load_checkpoint(checkpoint)
        trainer.load_state_dict(loaded)
        start_epoch = int(loaded.get("epoch", 0))
        it = int(loaded.get("it", 0))
        # The shuffle and the per-item augmentation RNG are keyed by (seed,
        # epoch): start the stream at the restored epoch.
        loader.epoch = start_epoch

    names = metric_names(train_params)
    feed = DevicePrefetch(loader.stream(train_params["num_epochs"] - start_epoch), device)
    profiler = None
    epochs, steps = [], 0
    t0 = time.perf_counter()
    with Logger(log_dir=log_dir, visualizer_params=config.get("visualizer_params"),
                **dict(train_params.get("log_params", {}))) as logger:
        epoch_steps = 0
        payload = trainer.state_dict  # called only when a checkpoint is written
        for epoch, batch, x in feed:
            if not epochs or epochs[-1] != epoch:
                epochs.append(epoch)
            if profile_dir and profiler is None and it >= PROFILE_STEPS[0]:
                profiler = _start_profiler(device)
            out = trainer.step(x)
            logger.stage_payload(payload)
            if profiler is not None and it >= PROFILE_STEPS[1]:
                _stop_profiler(profiler, device, profile_dir)
                profile_dir = None
                profiler = None
            logger.log_iter(it, names, out["metrics"], vis=lambda b=batch, o=out: _vis(b, o))
            out = None
            it += 1
            steps += 1
            epoch_steps += 1
            if epoch_steps == steps_per_epoch:
                epoch_steps = 0
                logger.log_epoch(epoch, payload)
        if profiler is not None:  # the run ended inside the profiled steps
            _stop_profiler(profiler, device, profile_dir)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
    return TrainRun(trainer, epochs, steps, wall_s, feed.wait_s)


def _vis(batch, out):
    """The train-vis gif's inputs as numpy in [0, 1] (a uint8 feed is
    undone) and the step's outputs with the keypoints split into source and
    driving. Called at log boundaries only: it waits on the card."""
    inp = {k: batch[k].astype("float32") / 255.0 if batch[k].dtype == "uint8" else batch[k]
           for k in ("source", "video")}
    kps = split_kp(out["kp_joined"], False)
    vis_out = {k: out[k].float().cpu().numpy() for k in ("video_prediction", "video_deformed")}
    for group, kp in kps.items():
        vis_out[group] = {k: v.float().cpu().numpy() for k, v in kp.items()}
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
