"""Data parallelism over a list of devices.

Counterpart of monkeynet_tpu/parallel/mesh.py. The JAX package's 1-D 'data'
mesh becomes a list of torch devices:

- training: one process a device, each holding a replica of the three
  networks and its slab of the global batch; the batch-norm statistics, the
  objective's means and the gradients are summed over the process group
  (parallel/distributed.py), so every rank takes the global-batch step
  (`make_sharded_train_step`);
- eval: one process, the frame axis of each chunk split into one slab a
  device, a replica of each network made on each device once
  (`make_frame_sharded_animator`, and the `devices` of tasks/animate.py's
  engines).

A device list may name one device more than once: that is how the CPU tests
(['cpu'] * N) and one card reach the sharded code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


def make_devices(num_devices: Optional[int] = None, devices: Optional[Sequence] = None
                 ) -> List[torch.device]:
    """The first `num_devices` of `devices` (default: every CUDA card).

    Raises when fewer devices exist than requested: silently truncating
    would let an N-way run succeed while it exercised fewer."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(f"requested {num_devices} devices but only {len(devices)} "
                             f"CUDA device(s) are available")
        devices = devices[:num_devices]
    return devices


def local_devices(num_devices: int, device="cuda") -> List[torch.device]:
    """The devices an N-way run of the port takes: `device` repeated N
    times where it is the CPU, the first N cards otherwise (a one-device
    run keeps the device it was given)."""
    device = torch.device(device)
    if device.type == "cpu":
        return make_devices(num_devices, [device] * num_devices)
    if num_devices == 1:
        return [device]
    return make_devices(num_devices)


def shard_batch(batch: Dict, devices: Sequence, axis: int = 0) -> List[Dict]:
    """Split each entry of `batch` along `axis` into one equal slab a
    device, each slab on its device: [{key: slab}, ...] in device order."""
    devices = [torch.device(d) for d in devices]
    out = [{} for _ in devices]
    for key, value in batch.items():
        value = torch.as_tensor(value)
        if value.shape[axis] % len(devices):
            raise ValueError(f"shard_batch: {key} has {value.shape[axis]} rows along axis "
                             f"{axis}, not divisible by {len(devices)} devices")
        for slab, part, device in zip(out, value.chunk(len(devices), dim=axis), devices):
            slab[key] = part.to(device)
    return out


def make_sharded_train_step(models, train_params, group, device="cuda", **trainer_kwargs):
    """A `Trainer` whose step is this rank's share of the global-batch step
    over `group`: batch-norm statistics, the objective's means and the
    gradients summed over the group. `step(local_batch)` /
    `run(...)` take this rank's slab (`shard_host_local_batch`)."""
    from monkeynet_tpu_torch.tasks.train import Trainer

    return Trainer(models, train_params, device=device, group=group, **trainer_kwargs)


def make_frame_sharded_animator(generator, devices: Sequence, **animator_kwargs):
    """Batch-of-frames inference with the frame axis split over `devices`:
    every frame is independent given its keypoints. The generator is
    replicated once at construction; a ragged chunk is padded to a multiple
    of lcm(16, len(devices)) and trimmed after. Returns the `Animator`:
    (source, kp_driving, kp_source) -> generator outputs on devices[0]."""
    from monkeynet_tpu_torch.tasks.animate import Animator

    return Animator(generator, devices=devices, **animator_kwargs)
