"""Checkpoint files in the reference's `.pth.tar` form.

One file, written by `torch.save`, holds what the reference Logger.save_cpk
writes (reference logger.py:43-47): the state_dicts of 'generator',
'kp_detector' and 'discriminator' (the port's keys are the reference's), the
Adam state_dicts as 'optimizer_<name>', and 'epoch' and 'it'; the port adds
its MultiStepLR positions as 'scheduler_<name>'. The JAX package reads the
same file through its `load_any` (monkeynet_tpu/utils/checkpoint.py), and
`load_checkpoint` reads the reference's own files. The JAX package's msgpack
checkpoints are not read here. In data-parallel training only rank 0
writes (utils/logger.py `write`).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def checkpoint_name(epoch: int, zfill: int = 8) -> str:
    return f"{str(epoch).zfill(zfill)}-checkpoint.pth.tar"


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write `payload` to `path` through a `.tmp` file and a rename, so a
    crash mid-write never leaves a truncated checkpoint under the real name."""
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, group=None) -> Dict[str, Any]:
    """The payload of a `.pth.tar` file, every tensor on the CPU. Only
    tensors and plain containers are unpickled (`weights_only`). With a
    process `group`, every rank waits for the others first (a barrier), so
    a file that one rank has just written is complete when any reads it."""
    if group is not None:
        torch.distributed.barrier(group=group)
    return torch.load(path, map_location="cpu", weights_only=True)
