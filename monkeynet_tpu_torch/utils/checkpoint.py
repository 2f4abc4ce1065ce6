"""Checkpoint files: the port writes the reference's `.pth.tar` form and
reads it and the JAX package's msgpack files.

One file, written by `torch.save`, holds what the reference Logger.save_cpk
writes (reference logger.py:43-47): the state_dicts of 'generator',
'kp_detector' and 'discriminator' (the port's keys are the reference's), the
Adam state_dicts as 'optimizer_<name>', and 'epoch' and 'it'; the port adds
its MultiStepLR positions as 'scheduler_<name>'. The JAX package reads the
same file through its `load_any` (monkeynet_tpu/utils/checkpoint.py), and
`load_checkpoint` reads the reference's own files. `load_any` reads either
form, and the JAX package's msgpack checkpoints (`<epoch>-checkpoint.
msgpack`, written by flax) through the port's own decoder (utils/msgpack.py)
and `utils/weights.py`. In data-parallel training only rank 0 writes
(utils/logger.py `write`).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from monkeynet_tpu_torch.utils.msgpack import read_msgpack
from monkeynet_tpu_torch.utils.weights import from_jax_variables, from_optax_adam


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


def _is_torch_file(path: str) -> bool:
    """The JAX package's test (monkeynet_tpu/utils/checkpoint.py `load_any`):
    a zip archive (torch.save's format) or a `.pth` / `.pth.tar` / `.pt`
    name is a torch file; anything else is msgpack."""
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic == b"PK" or path.endswith((".pth", ".pth.tar", ".pt"))


def from_jax_checkpoint(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A decoded JAX package checkpoint in the port's payload form.

    A train checkpoint, {'state': {'step', 'params', 'batch_stats',
    'opt_states'}, 'epoch', 'it'} (monkeynet_tpu/tasks/train_loop.py
    `_make_payload`), gives each network's state_dict (the discriminator has
    no batch statistics), its Adam moments as 'optimizer_<name>' in
    `from_optax_adam`'s form, keyed by parameter name ('step', 'exp_avg',
    'exp_avg_sq'; `Trainer.load_state_dict` orders them as its Adam holds
    them) and 'epoch' and 'it' (0-d arrays in the file). It has no
    'scheduler_<name>': the Trainer resumes each MultiStepLR at Adam's
    step, the count the JAX schedule reads. A file of bare networks,
    {'<name>': {'params', 'batch_stats'}}, gives their state_dicts."""
    if "state" in tree:
        state = tree["state"]
        networks = {name: (params, state.get("batch_stats", {}).get(name, {}))
                    for name, params in state["params"].items()}
        opt_states = state.get("opt_states", {})
    else:
        networks = {name: (v["params"], v.get("batch_stats", {}))
                    for name, v in tree.items() if isinstance(v, dict) and "params" in v}
        opt_states = {}
    out: Dict[str, Any] = {}
    for name, (params, batch_stats) in networks.items():
        out[name] = from_jax_variables(params, batch_stats)
        if name in opt_states:
            out[f"optimizer_{name}"] = from_optax_adam(opt_states[name])
    for key in ("epoch", "it"):
        if key in tree:
            out[key] = int(np.asarray(tree[key]))
    return out


def load_any(path: str, group=None) -> Dict[str, Any]:
    """The payload of a checkpoint in either package's form: the port's or
    the reference's `.pth.tar` as `load_checkpoint` gives it, or the JAX
    package's msgpack as `from_jax_checkpoint` gives it. With a process
    `group`, every rank waits for the others first (a barrier)."""
    if _is_torch_file(path):
        return load_checkpoint(path, group=group)
    if group is not None:
        torch.distributed.barrier(group=group)
    return from_jax_checkpoint(read_msgpack(path))
