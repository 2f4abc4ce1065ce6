"""Several processes, one device each: joining a group, spawning ranks, and
the collectives the sharded paths use.

Counterpart of monkeynet_tpu/parallel/distributed.py. The JAX package runs
one program over a mesh and lets shard_map place the psum / pmean of the
batch-norm statistics and of the objective; here each device is a process
(rank) of a `torch.distributed` group, and the step calls the collectives
itself:

- `maybe_initialize_distributed` joins the group that torchrun describes in
  the environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), and touches
  nothing without it, as the JAX function does with its JAX_* variables.
- `spawn` starts one worker process a device (start method 'spawn'), joins
  them into a group of the caller's backend (NCCL on the card, gloo on the
  CPU) and returns what each worker's function returned.
- `shard_host_local_batch` gives a rank its contiguous slab of a global
  batch, on its device.
- `all_reduce_sum` is a differentiable sum over the group: its backward sums
  the cotangents over the group, the transpose of JAX's psum.

Every collective of the sharded paths goes through `all_reduce_sum`,
`all_reduce_` or `all_gather_cat`, which count the collectives they issue in
`collective_count` (a captured collective counts once, at the capture, as
the kernel wrappers' launches do).
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class _Count:
    collectives = 0


collective_count = _Count()


def maybe_initialize_distributed() -> bool:
    """Join the process group that torchrun's environment describes; return
    True if there is one (already joined, or joined now).

    Without RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT this returns False
    and touches nothing. The backend is NCCL where CUDA is available and
    gloo otherwise; on the card each process takes the device LOCAL_RANK
    names (torchrun sets it), so the ranks of a host use distinct cards. A
    failed join raises.
    """
    if not all(key in os.environ for key in ENV_KEYS):
        return False
    if dist.is_initialized():
        return True
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def group_rank(group=None) -> int:
    return dist.get_rank(group) if group is not None else 0


def group_size(group=None) -> int:
    return dist.get_world_size(group) if group is not None else 1


def backend_of(group) -> str:
    """The backend of `group` ('nccl', 'gloo', ...)."""
    return str(dist.get_backend(group)).lower()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        collective_count.collectives += 1
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of `tensor` over the ranks of `group`, in a new tensor. The
    gradient flows: the backward sums the cotangents over the group (every
    rank must run it, as every rank runs the forward)."""
    return _AllReduceSum.apply(tensor, group)


@torch.no_grad()
def all_reduce_(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `tensor` over `group` in place, outside autograd."""
    collective_count.collectives += 1
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


@torch.no_grad()
def all_gather_cat(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors of `group` (equal shapes) concatenated along
    `dim` in rank order."""
    parts = [torch.empty_like(tensor) for _ in range(group_size(group))]
    collective_count.collectives += 1
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def shard_host_local_batch(batch: Dict, device, group=None, batch_axis: int = 0) -> Dict:
    """This rank's contiguous slab of a global batch, as tensors on `device`.

    batch: {key: array or tensor} whose `batch_axis` is the global batch,
    which must divide by the group's size. Rank r takes rows
    [r * B / N, (r + 1) * B / N): the same slab the sharded loader gives it,
    so the ranks' slabs together are the single-process batch.
    """
    rank, world = group_rank(group), group_size(group)
    out = {}
    for key, value in batch.items():
        value = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
        size = value.shape[batch_axis]
        if size % world:
            raise ValueError(f"shard_host_local_batch: {key} has {size} rows along axis "
                             f"{batch_axis}, not divisible by the group's {world} ranks")
        local = size // world
        out[key] = value.narrow(batch_axis, rank * local, local).to(device)
    return out


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, init_method: str, backend: str, device: str,
            fn: Callable, args: tuple, results) -> None:
    """One rank: set its device, join the group, run fn(rank, world, device,
    *args), send back its pickled result (or the traceback), leave the
    group."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, devices: Sequence, backend: str, args: tuple = (),
          timeout: Optional[float] = None) -> List:
    """Run fn(rank, world, device, *args) in one new process for each entry
    of `devices`, joined into a group of `backend`; return the results in
    rank order.

    `fn` must be importable at module level (the processes start fresh and
    import it), and so must `args` and the result pickle; results cross as
    plain pickles, so return CPU tensors or numpy. A device may appear more
    than once (gloo allows two ranks on one card; NCCL refuses them). If a
    rank fails or dies, the others are stopped and the failure raises here.
    `timeout` None (the default) sets no deadline, as a training run of
    hours needs; past a given `timeout` seconds every rank is stopped and
    TimeoutError raises.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    world = len(devices)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(rank, world, init_method, backend, str(device), fn, args,
                               results))
             for rank, device in enumerate(devices)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got: Dict[int, object] = {}
    try:
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with codes "
                                       f"{[procs[i].exitcode for i in dead]} and no result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world - len(got)} of {world} ranks gave no "
                                       f"result within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:  # a rank that sent its result is leaving the group
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    return [got[rank] for rank in range(world)]
