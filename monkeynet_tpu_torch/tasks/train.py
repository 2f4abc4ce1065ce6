"""GAN training: one step over the three networks.

Counterpart of `make_train_step` in monkeynet_tpu/tasks/train.py. The step
builds one scalar objective, loss_G + loss_D, whose detach placement routes
the gradients as the JAX package's stop_gradients do:

  * generator     <- dL_G/dG. L_D sees the fake detached.
  * discriminator <- dL_D/dD. L_G evaluates the discriminator with its
                     parameters detached, so L_G adds nothing to them.
  * kp detector   <- dL_G/dKP, plus dL_D/dKP unless `detach_kp_discriminator`;
                     `detach_kp_generator` detaches the keypoints the
                     generator sees.

All three gradients are taken at the pre-update parameters in one backward
pass, then the three optimizers step. The kp detector runs once on
cat([source, video]) and the generator once, so batch-norm running
statistics update once per step (the discriminator has none).

Mixed precision (`train_params['compute_dtype']`, e.g. 'bfloat16'): the
master parameters stay f32 and are cast to the compute dtype at the top of
every step, with the gradient flowing back through the cast, as the JAX
package casts its parameter tree inside the objective. The networks run on
the cast copies through `torch.func.functional_call`. This is not
`torch.autocast`: autocast picks a dtype per op from its own lists, while
the JAX package runs every layer in the compute dtype and keeps f32 exactly
where the modules say so (batch-norm statistics, keypoint math, the mask
softmax, every sampling grid), and the port is held against that.

Rematerialisation (`train_params['remat']`): the kp detector's and the
generator's forwards run under `torch.utils.checkpoint` and are computed
again in the backward instead of keeping their activations, as the JAX
package wraps them in `jax.checkpoint`. The recompute leaves the batch-norm
running statistics alone (`frozen_running_stats`), so that a remat step
updates them once, as a plain step does.

Several steps a dispatch (`Trainer.run`, the counterpart of
`make_multi_train_step`): k steps over k stacked batches, or over k stacked
augmentation plans that the step turns into its batch on the device
(data/device_feed.py). On the card the step is captured once in a CUDA graph
and replayed, so the host makes a handful of calls a step instead of
launching every kernel. For that the optimizers are Adam with
`capturable=True`, whose rate is a tensor on the card that the host
schedule fills before every step: a Python float would be baked into the
graph at capture. On the CPU the same method takes eager steps.

Data parallelism (`group`, the counterpart of `axis_name`): each rank of a
`torch.distributed` group holds a replica of the three networks and takes
its slab of the global batch. The batch norms sum their statistics over the
group (models/blocks.py), each loss mean is divided by the group's size so
that the ranks' objectives add up to the global-batch mean (the JAX
package's `gmean`, a pmean), the metrics are summed over the group, and
after the backward each network's gradients are summed over the group in
one flat all-reduce before its optimizer steps: the sum that shard_map's
transpose makes of the replicated parameters' cotangents. The networks are
not wrapped in DistributedDataParallel. Under an NCCL group the collectives
are captured in the step's CUDA graph with the kernels (the eager warm-up
steps before the capture create the communicator); a gloo group cannot be
captured, so on the card its steps are eager (`graph=False`).

The loop around the step (loader, logger, checkpoints, resume) is
tasks/train_loop.py.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from monkeynet_tpu_torch.models.blocks import frozen_running_stats, set_process_group
from monkeynet_tpu_torch.ops.cuda import launch_counts
from monkeynet_tpu_torch.parallel.distributed import (
    all_reduce_,
    backend_of,
    collective_count,
    group_size,
)
from monkeynet_tpu_torch.tasks.animate import split_kp
from monkeynet_tpu_torch.tasks.losses import (
    discriminator_loss,
    discriminator_loss_names,
    generator_loss,
    generator_loss_names,
)
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.tracing import span
from monkeynet_tpu_torch.utils.weights import adam_state_dict

MODEL_NAMES = ("generator", "discriminator", "kp_detector")
# Eager steps before a capture, undone afterwards: they build the kernels,
# make the optimizers' state, and run every lazy initialisation of cuBLAS,
# cuDNN and the allocator outside the captured region.
GRAPH_WARMUP_STEPS = 2
# The side stream of the warm-up steps, one a device for every capture:
# PyTorch keeps a cuBLAS workspace (32 MiB on the H100) for each stream and
# thread that calls cuBLAS, for the life of the process, so a fresh stream
# a capture would leave one or two behind every time.
_WARMUP_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[index] = torch.cuda.Stream(index)
    return _WARMUP_STREAMS[index]


def multistep_lr(base_lr: float, milestones, steps_per_epoch: int, gamma: float = 0.1):
    """MultiStepLR as a function of the step:
    lr = base * gamma^(number of milestone epochs passed)."""
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * gamma ** sum(epoch >= m for m in milestones)

    return schedule


def make_optimizer(params: Iterable[nn.Parameter], train_params: Dict, steps_per_epoch: int,
                   capturable: bool = False):
    """(Adam(betas=(0.5, 0.999), eps=1e-8), MultiStepLR over
    `epoch_milestones` x `steps_per_epoch`), the scheduler stepped once per
    train step: the same rates as `multistep_lr`. `capturable` (CUDA only)
    keeps Adam's step counts on the card, so that its step can be captured
    in a CUDA graph."""
    optimizer = torch.optim.Adam(params, lr=train_params["lr"], betas=(0.5, 0.999), eps=1e-8,
                                 capturable=capturable)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer,
        milestones=sorted(m * steps_per_epoch for m in train_params["epoch_milestones"]),
        gamma=0.1,
    )
    return optimizer, scheduler


def largest_divisor_leq(n: int, k: int) -> int:
    """Largest divisor of n that is <= k (>= 1): the steps a dispatch that
    tile the run's step count exactly."""
    k = max(1, min(k, n))
    for d in range(k, 0, -1):
        if n % d == 0:
            return d
    return 1


def metric_names(train_params) -> list:
    return generator_loss_names(train_params["loss_weights"]) + discriminator_loss_names()


def _gmean(v, world: int = 1):
    """This rank's share of the global-batch mean of a per-sample loss
    vector, in f32: its batch mean over the group's size (the ranks' shares
    add up to the global mean, as the JAX package's pmean gives it)."""
    m = v.float().mean()
    return m if world == 1 else m / world


class Trainer:
    """The three networks, their optimizers and the train step.

    models: {'generator', 'discriminator', 'kp_detector'}; they are moved to
      `device`, put in training mode and updated in place.
    optimizer_factory: parameters -> torch optimizer, used for each network
      in place of the default Adam with its MultiStepLR (no schedule then).
    group: a torch.distributed process group to take the global-batch step
      over (each rank passes its slab of the batch). The Trainer is what
      sets the networks' batch norms to reduce over it (None: this process's
      batch alone). Every rank builds the same initial weights.

    `step` takes one eager step; `run` takes several steps of a stacked
    chunk, through a CUDA graph on the card. `graph_stats` counts what the
    graph did: the eager warm-up steps before its capture, the kernel
    launches and the collectives that the capture recorded (the counters see
    a captured launch once, at the capture, and no replay), and the
    replays.
    """

    def __init__(self, models: Dict[str, nn.Module], train_params: Dict, device="cuda",
                 steps_per_epoch: int = 1,
                 optimizer_factory: Optional[Callable] = None, group=None):
        self.device = require_device(device)
        self.train_params = train_params
        self.group = group
        self.world = group_size(group)
        self.models = {name: set_process_group(models[name].to(self.device).train(), group)
                       for name in MODEL_NAMES}
        compute_dtype = train_params.get("compute_dtype")
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.remat = bool(train_params.get("remat", False))
        capturable = self.device.type == "cuda"
        self.optimizers, self.schedulers = {}, {}
        for name, model in self.models.items():
            if optimizer_factory is not None:
                self.optimizers[name] = optimizer_factory(model.parameters())
            else:
                self.optimizers[name], self.schedulers[name] = make_optimizer(
                    model.parameters(), train_params, steps_per_epoch, capturable=capturable
                )
        # the schedulers' rate as a function of the step, for a resume that
        # sets their position (`load_state_dict`)
        self._schedule = None if optimizer_factory is not None else multistep_lr(
            train_params["lr"], train_params["epoch_milestones"], steps_per_epoch)
        # On the card the scheduled rates reach Adam as tensors, filled from
        # the host schedule before every step (`_load_rates`); the param
        # groups keep the host's float, which is what checkpoints hold.
        self._rates = {name: torch.zeros((), device=self.device)
                       for name in self.schedulers if capturable}
        self._graph = None
        self.graph_stats = {"warmup_steps": 0, "captured": {}, "captured_collectives": 0,
                            "replays": 0}

    def _cast(self, t):
        if self.compute_dtype is not None and t.is_floating_point():
            return t.to(self.compute_dtype)
        return t

    def _prepare(self, batch):
        """Move the batch to the device; a uint8 batch is rescaled there to
        [0, 1] in the compute dtype."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=self.device)
            if v.dtype == torch.uint8:
                v = v.to(self.compute_dtype or torch.float32) / 255.0
            out[k] = self._cast(v)
        return out

    def _forward(self, name, params, args):
        """functional_call of one network; under remat, recomputed in the
        backward with its running statistics left alone the second time."""
        model = self.models[name]
        if not self.remat:
            return functional_call(model, params, args)
        calls = []

        def run(*inputs):
            calls.append(None)
            if len(calls) == 1:
                return functional_call(model, params, inputs)
            with frozen_running_stats(model):
                return functional_call(model, params, inputs)

        # No random ops run here, so there is no RNG state to carry over
        # (saving it would read the generator, which a capture refuses).
        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)

    def objective(self, batch):
        """loss_G + loss_D at the current parameters, with the metrics, the
        generator's outputs and the joined keypoints."""
        tp = self.train_params
        loss_weights = tp["loss_weights"]
        params = {
            name: {k: self._cast(p) for k, p in model.named_parameters()}
            for name, model in self.models.items()
        }
        batch = self._prepare(batch)
        source, video = batch["source"], batch["video"]

        kp_joined = self._forward("kp_detector", params["kp_detector"],
                                  (torch.cat([source, video], dim=1),))
        kps = split_kp(kp_joined, tp["detach_kp_generator"])
        generated = self._forward("generator", params["generator"],
                                  (source, kps["kp_driving"], kps["kp_source"]))

        def discriminate(d_params, frames, kp):
            return functional_call(
                self.models["discriminator"], d_params,
                (frames, kp["kp_driving"], kp["kp_source"]),
            )

        # Generator objective: the discriminator with frozen parameters, on
        # keypoints that are not detached.
        kp_nodetach = split_kp(kp_joined, False)
        d_frozen = {k: p.detach() for k, p in params["discriminator"].items()}
        maps_fake = discriminate(d_frozen, generated["video_prediction"], kp_nodetach)
        maps_real = discriminate(d_frozen, video, kp_nodetach)
        gen_losses = generator_loss(
            maps_fake, maps_real, generated["video_deformed"], loss_weights
        )
        gen_means = [_gmean(v, self.world) for v in gen_losses]

        # Discriminator objective on the detached fake.
        kp_disc = split_kp(kp_joined, tp["detach_kp_discriminator"])
        fake = generated["video_prediction"].detach()
        maps_fake_d = discriminate(params["discriminator"], fake, kp_disc)
        maps_real_d = discriminate(params["discriminator"], video, kp_disc)
        disc_means = [
            _gmean(v, self.world)
            for v in discriminator_loss(maps_fake_d, maps_real_d, loss_weights)
        ]

        metrics = torch.stack(gen_means + disc_means)
        if self.group is not None:
            metrics = all_reduce_(metrics.detach().clone(), self.group)
        return sum(gen_means) + sum(disc_means), metrics, generated, kp_joined

    def _update(self, batch) -> Dict:
        """The step's work on the device: gradients at the current
        parameters, then the three optimizer steps. Leaves the host
        schedules alone; nothing in it waits on the card."""
        for optimizer in self.optimizers.values():
            optimizer.zero_grad(set_to_none=True)
        loss, metrics, generated, kp_joined = self.objective(batch)
        loss.backward()
        if self.group is not None:
            self._sum_gradients()
        for name in MODEL_NAMES:
            optimizer = self.optimizers[name]
            rate = self._rates.get(name)
            if rate is None:
                optimizer.step()
                continue
            (group,) = optimizer.param_groups
            host_lr, group["lr"] = group["lr"], rate
            try:
                optimizer.step()
            finally:
                group["lr"] = host_lr
        return {
            "metrics": metrics.detach(),
            "video_prediction": generated["video_prediction"].detach(),
            "video_deformed": generated["video_deformed"].detach(),
            "kp_joined": {k: v.detach() for k, v in kp_joined.items()},
        }

    @torch.no_grad()
    def _sum_gradients(self) -> None:
        """Sum each network's gradients over the group: one flat all-reduce
        a network, the same order on every rank."""
        for name in MODEL_NAMES:
            grads = [p.grad for p in self.models[name].parameters() if p.grad is not None]
            if not grads:
                continue
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), self.group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def _load_rates(self) -> None:
        for name, rate in self._rates.items():
            rate.fill_(self.optimizers[name].param_groups[0]["lr"])

    def _advance_schedules(self) -> None:
        for scheduler in self.schedulers.values():
            scheduler.step()

    def step(self, batch) -> Dict:
        """One train step on {'source': (B,1,H,W,C), 'video': (B,Dv,H,W,C)},
        float in [0, 1] or uint8. Returns {'metrics' (in `metric_names`
        order), 'video_prediction', 'video_deformed', 'kp_joined'}, detached
        and on the device."""
        self._load_rates()
        out = self._update(batch)
        self._advance_schedules()
        return out

    def run(self, chunk: Dict, start: int = 0, stop: Optional[int] = None,
            vis_steps: Iterable[int] = (), augment: Optional[Callable] = None,
            graph: bool = True):
        """Steps `start` .. `stop` - 1 of a chunk of stacked step inputs.

        chunk: {key: (k, ...) tensor}: 'source' and 'video' batches, or with
          `augment` (plan -> {'source', 'video'} f32 on the device, e.g. the
          device feed's executor bound to its video cache) one plan a step.
        vis_steps: the steps whose visuals to keep.

        Returns (metrics (stop - start, M) f32 on the device, {j: visuals})
        with `step`'s outputs for each j in vis_steps (and, with `augment`,
        the step's augmented 'source' and 'video'). On the card the first
        call captures the step in a CUDA graph, which every later call
        replays; a capture that fails raises. `graph` False, and the CPU,
        take eager steps. A non-NCCL group cannot be captured: on the card
        it needs `graph` False, and raises otherwise.
        """
        if (graph and self.device.type == "cuda" and self.group is not None
                and backend_of(self.group) != "nccl"):
            raise ValueError(f"Trainer.run: a {backend_of(self.group)} group's collectives "
                             "cannot be captured in a CUDA graph; pass graph=False for eager "
                             "steps")
        stop = len(next(iter(chunk.values()))) if stop is None else stop
        vis_steps = set(vis_steps)
        with span("trainer.run"):
            if self.device.type != "cuda" or not graph:
                metrics, vis = [], {}
                for j in range(start, stop):
                    with span("trainer.step"):
                        batch = {k: v[j] for k, v in chunk.items()}
                        if augment is not None:
                            with torch.no_grad():
                                batch = augment(batch)
                        out = self.step(batch)
                        metrics.append(out["metrics"])
                        if j in vis_steps:
                            vis[j] = dict(out, **batch) if augment is not None else out
                return torch.stack(metrics), vis

            static, captured, out = self._graph_for(chunk, start, augment)
            metrics = torch.empty((stop - start,) + tuple(out["metrics"].shape),
                                  dtype=out["metrics"].dtype, device=self.device)
            vis = {}
            for j in range(start, stop):
                with span("trainer.step"):
                    for k, v in static.items():
                        v.copy_(chunk[k][j])
                    self._load_rates()
                    captured.replay()
                    self._advance_schedules()
                    self.graph_stats["replays"] += 1
                    metrics[j - start].copy_(out["metrics"])
                    if j in vis_steps:
                        vis[j] = _clone_tree(out)
            return metrics, vis

    @property
    def graph(self):
        """The captured CUDA graph of the step (None before `run` captured
        it on the card)."""
        return None if self._graph is None else self._graph[1][1]

    def _graph_for(self, chunk, start, augment):
        """The captured step for this chunk's inputs: captured at the first
        call, then checked against every later one."""
        signature = (augment,
                     tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in sorted(chunk.items())))
        if self._graph is None:
            self._graph = (signature, self._capture({k: v[start] for k, v in chunk.items()},
                                                    augment))
        elif self._graph[0] != signature:
            raise ValueError("Trainer.run: the chunk's inputs differ from those the CUDA graph "
                             "was captured with")
        return self._graph[1]

    def _capture(self, slot, augment):
        """Capture one step in a CUDA graph, PyTorch's whole-network recipe:
        eager warm-up steps on a side stream (then undone, so the run's
        steps are all replays), grads set to None, and the step captured
        with its inputs read from static tensors. Returns (static inputs,
        graph, static outputs)."""
        static = {k: v.clone() for k, v in slot.items()}

        def body():
            batch = static
            if augment is not None:
                with torch.no_grad():
                    batch = augment(static)
            out = self._update(batch)
            if augment is not None:
                out.update(source=batch["source"], video=batch["video"])
            return out

        saved, fresh = self._snapshot()
        side = _warmup_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_STEPS):
                self._load_rates()
                body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._restore(saved, fresh)
        del saved
        for optimizer in self.optimizers.values():
            optimizer.zero_grad(set_to_none=True)
        before, collectives = launch_counts(), collective_count.collectives
        graph = torch.cuda.CUDAGraph()
        # With a group, the process group's watchdog thread polls the
        # events of earlier collectives; in the default 'global' mode that
        # poll from another thread would invalidate the capture.
        mode = "global" if self.group is None else "thread_local"
        try:
            with torch.cuda.graph(graph, capture_error_mode=mode):
                out = body()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the train step in a CUDA graph failed ({e}); "
                "train_params.steps_per_dispatch: 1 takes eager steps"
            ) from e
        after = launch_counts()
        self.graph_stats["warmup_steps"] += GRAPH_WARMUP_STEPS
        self.graph_stats["captured"] = {k: after[k] - before[k] for k in after}
        self.graph_stats["captured_collectives"] = collective_count.collectives - collectives
        return static, graph, out

    def _snapshot(self):
        """Copies of every tensor a step changes: parameters, buffers and
        optimizer state; and the (optimizer, parameter) pairs that have no
        optimizer state yet."""
        tensors = [t for model in self.models.values()
                   for t in (*model.parameters(), *model.buffers())]
        fresh = []
        for optimizer in self.optimizers.values():
            for group in optimizer.param_groups:
                for p in group["params"]:
                    state = optimizer.state.get(p)
                    if state:
                        tensors += [v for v in state.values() if torch.is_tensor(v)]
                    else:
                        fresh.append((optimizer, p))
        return [(t, t.detach().clone()) for t in tensors], fresh

    @torch.no_grad()
    def _restore(self, saved, fresh) -> None:
        """Undo the steps taken since `_snapshot`, in place. State that the
        optimizers made in those steps is zeroed, Adam's fresh state; the
        tensors stay, so a capture finds it made."""
        for t, value in saved:
            t.copy_(value)
        for optimizer, p in fresh:
            for v in optimizer.state[p].values():
                if torch.is_tensor(v):
                    v.zero_()

    def state_dict(self) -> Dict:
        """The entries of a reference checkpoint: each network's state_dict
        under its name, its optimizer's as 'optimizer_<name>', and its
        MultiStepLR's as 'scheduler_<name>'. The optimizer's state is in the
        form an eager Adam keeps: step counts as f32 CPU tensors and
        `capturable` False."""
        out = {}
        for name in MODEL_NAMES:
            out[name] = self.models[name].state_dict()
            out[f"optimizer_{name}"] = _eager_optimizer_state(self.optimizers[name].state_dict())
            if name in self.schedulers:
                out[f"scheduler_{name}"] = self.schedulers[name].state_dict()
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Restore what `state_dict` gives, or the part of it that `state`
        holds: a network absent from `state` keeps its weights. An optimizer
        entry may also be a JAX package file's Adam moments, keyed by
        parameter name (utils/weights.py `from_optax_adam`); they are put in
        the order this network's Adam holds its parameters. Where a
        network's optimizer state comes without a scheduler's (the
        reference's own checkpoints, the JAX package's), the scheduler
        resumes at the optimizer's step, with the rate the schedule gives
        there, as the JAX package's schedule does on resume
        (`restore_adam_moments` in monkeynet_tpu/tasks/train.py). A captured
        graph is dropped (the optimizer state it read is replaced)."""
        self._graph = None
        for name in MODEL_NAMES:
            if name not in state:
                continue
            self.models[name].load_state_dict(state[name])
            opt_state = state.get(f"optimizer_{name}")
            if opt_state is not None:
                optimizer = self.optimizers[name]
                if "exp_avg" in opt_state:
                    group = dict(optimizer.param_groups[0], capturable=False)
                    opt_state = adam_state_dict(
                        opt_state, [n for n, _ in self.models[name].named_parameters()], group)
                optimizer.load_state_dict(opt_state)
                if name in self._rates:
                    _make_capturable(optimizer)
            if name not in self.schedulers:
                continue
            scheduler = self.schedulers[name]
            if f"scheduler_{name}" in state:
                scheduler.load_state_dict(state[f"scheduler_{name}"])
            elif opt_state is not None and opt_state["state"]:
                scheduler.last_epoch = max(int(s["step"]) for s in opt_state["state"].values())
                for group in scheduler.optimizer.param_groups:
                    group["lr"] = self._schedule(scheduler.last_epoch)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _eager_optimizer_state(state: Dict) -> Dict:
    """An optimizer state_dict in the form a non-capturable Adam gives it."""
    if not any(group.get("capturable") for group in state["param_groups"]):
        return state
    return {
        "state": {idx: {k: (v.detach().to("cpu", torch.float32) if k == "step" else v)
                        for k, v in entry.items()}
                  for idx, entry in state["state"].items()},
        "param_groups": [dict(group, capturable=False) for group in state["param_groups"]],
    }


def _make_capturable(optimizer) -> None:
    """After load_state_dict of an eager-form state: capturable groups, step
    counts on the parameters' device."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(device=p.device, dtype=torch.float32)
