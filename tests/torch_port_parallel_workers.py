"""Rank functions for tests/test_torch_port_parallel.py.

`monkeynet_tpu_torch.parallel.distributed.spawn` starts each rank in a
fresh process that imports its function by module path, so they live here,
in a module that imports torch and the port and nothing of JAX (a spawned
rank then starts in a couple of seconds).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from monkeynet_tpu_torch.models.blocks import SyncBatchNorm, set_process_group
from monkeynet_tpu_torch.parallel import make_sharded_train_step
from monkeynet_tpu_torch.parallel.distributed import collective_count, shard_host_local_batch
from monkeynet_tpu_torch.tasks.build import build_train_models
from monkeynet_tpu_torch.tasks.train import MODEL_NAMES

# The ranks of a test share the CPU with the test runner's other workers.
THREADS = 2


def sgd(params):
    return torch.optim.SGD(params, lr=1.0)


def batchnorm_and_step_rank(rank, world, device, bn_case, config, state_dicts, batch):
    """On each rank of a gloo group: (1) a SyncBatchNorm reducing over the
    group, forward and backward of sum(y * dout) on this rank's slab of x;
    (2) one SGD(1.0) train step of the three networks on this rank's slab
    of `batch`, plain and with remat (whose recompute all-reduces again);
    (3) whether the step's run() refuses a CUDA graph for this group on a
    card. Returns them on the CPU."""
    torch.set_num_threads(THREADS)
    group = dist.group.WORLD
    x, dout, running = bn_case
    bn = set_process_group(SyncBatchNorm(x.shape[-1]), group).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(running["mean"]))
        bn.running_var.copy_(torch.from_numpy(running["var"]))
        bn.weight.copy_(torch.from_numpy(running["scale"]))
        bn.bias.copy_(torch.from_numpy(running["bias"]))
    slab = shard_host_local_batch({"x": x, "dout": dout}, device, group)
    xs = slab["x"].requires_grad_()
    y = bn(xs)
    (y * slab["dout"]).sum().backward()
    bn_out = {"y": y.detach(), "dx": xs.grad, "dweight": bn.weight.grad,
              "dbias": bn.bias.grad, **{k: v.clone() for k, v in bn.state_dict().items()}}

    slab = shard_host_local_batch(batch, device, group)
    steps = {}
    for remat in (False, True):
        models = build_train_models(config, device="cpu")
        for name, model in models.items():
            model.load_state_dict(state_dicts[name])
        trainer = make_sharded_train_step(models, dict(config["train_params"], remat=remat),
                                          group, device=device, optimizer_factory=sgd)
        before = collective_count.collectives
        out = trainer.step(slab)
        steps[remat] = {"state": {name: models[name].state_dict() for name in MODEL_NAMES},
                        "metrics": out["metrics"],
                        "collectives": collective_count.collectives - before}
    # a gloo group cannot be captured: on the card run() refuses the graph
    trainer.device = torch.device("cuda")
    try:
        trainer.run({k: v[None] for k, v in slab.items()}, graph=True)
        refused = False
    except ValueError as e:
        refused = "gloo" in str(e)
    return {"bn": bn_out, **steps[False], "remat": steps[True], "graph_refused": refused,
            "norms": sum(isinstance(m, SyncBatchNorm) for name in ("generator", "kp_detector")
                         for m in models[name].modules())}


def sleep_rank(rank, world, device, seconds):
    """Answer after `seconds` of wall time."""
    time.sleep(seconds)
    return rank
