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

The loop around the step (loader, logger, checkpoints, resume) is
tasks/train_loop.py. Not here yet: rematerialisation, several steps per
dispatch, and data parallelism.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn
from torch.func import functional_call

from monkeynet_tpu_torch.tasks.animate import split_kp
from monkeynet_tpu_torch.tasks.losses import (
    discriminator_loss,
    discriminator_loss_names,
    generator_loss,
    generator_loss_names,
)
from monkeynet_tpu_torch.utils.device import require_device

MODEL_NAMES = ("generator", "discriminator", "kp_detector")


def multistep_lr(base_lr: float, milestones, steps_per_epoch: int, gamma: float = 0.1):
    """MultiStepLR as a function of the step:
    lr = base * gamma^(number of milestone epochs passed)."""
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * gamma ** sum(epoch >= m for m in milestones)

    return schedule


def make_optimizer(params: Iterable[nn.Parameter], train_params: Dict, steps_per_epoch: int):
    """(Adam(betas=(0.5, 0.999), eps=1e-8), MultiStepLR over
    `epoch_milestones` x `steps_per_epoch`), the scheduler stepped once per
    train step: the same rates as `multistep_lr`."""
    optimizer = torch.optim.Adam(params, lr=train_params["lr"], betas=(0.5, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer,
        milestones=sorted(m * steps_per_epoch for m in train_params["epoch_milestones"]),
        gamma=0.1,
    )
    return optimizer, scheduler


def metric_names(train_params) -> list:
    return generator_loss_names(train_params["loss_weights"]) + discriminator_loss_names()


def _gmean(v):
    """Batch mean of a per-sample loss vector, in f32."""
    return v.float().mean()


class Trainer:
    """The three networks, their optimizers and the train step.

    models: {'generator', 'discriminator', 'kp_detector'}; they are moved to
      `device`, put in training mode and updated in place.
    optimizer_factory: parameters -> torch optimizer, used for each network
      in place of the default Adam with its MultiStepLR (no schedule then).
    """

    def __init__(self, models: Dict[str, nn.Module], train_params: Dict, device="cuda",
                 steps_per_epoch: int = 1,
                 optimizer_factory: Optional[Callable] = None):
        self.device = require_device(device)
        self.train_params = train_params
        self.models = {name: models[name].to(self.device).train() for name in MODEL_NAMES}
        compute_dtype = train_params.get("compute_dtype")
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.optimizers, self.schedulers = {}, {}
        for name, model in self.models.items():
            if optimizer_factory is not None:
                self.optimizers[name] = optimizer_factory(model.parameters())
            else:
                self.optimizers[name], self.schedulers[name] = make_optimizer(
                    model.parameters(), train_params, steps_per_epoch
                )

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

        kp_joined = functional_call(
            self.models["kp_detector"], params["kp_detector"],
            (torch.cat([source, video], dim=1),),
        )
        kps = split_kp(kp_joined, tp["detach_kp_generator"])
        generated = functional_call(
            self.models["generator"], params["generator"],
            (source, kps["kp_driving"], kps["kp_source"]),
        )

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
        gen_means = [_gmean(v) for v in gen_losses]

        # Discriminator objective on the detached fake.
        kp_disc = split_kp(kp_joined, tp["detach_kp_discriminator"])
        fake = generated["video_prediction"].detach()
        maps_fake_d = discriminate(params["discriminator"], fake, kp_disc)
        maps_real_d = discriminate(params["discriminator"], video, kp_disc)
        disc_means = [
            _gmean(v) for v in discriminator_loss(maps_fake_d, maps_real_d, loss_weights)
        ]

        metrics = torch.stack(gen_means + disc_means)
        return sum(gen_means) + sum(disc_means), metrics, generated, kp_joined

    def step(self, batch) -> Dict:
        """One train step on {'source': (B,1,H,W,C), 'video': (B,Dv,H,W,C)},
        float in [0, 1] or uint8. Returns {'metrics' (in `metric_names`
        order), 'video_prediction', 'video_deformed', 'kp_joined'}, detached
        and on the device."""
        for optimizer in self.optimizers.values():
            optimizer.zero_grad(set_to_none=True)
        loss, metrics, generated, kp_joined = self.objective(batch)
        loss.backward()
        for name in MODEL_NAMES:
            self.optimizers[name].step()
            if name in self.schedulers:
                self.schedulers[name].step()
        return {
            "metrics": metrics.detach(),
            "video_prediction": generated["video_prediction"].detach(),
            "video_deformed": generated["video_deformed"].detach(),
            "kp_joined": {k: v.detach() for k, v in kp_joined.items()},
        }

    def state_dict(self) -> Dict:
        """The entries of a reference checkpoint: each network's state_dict
        under its name, its optimizer's as 'optimizer_<name>', and its
        MultiStepLR's as 'scheduler_<name>'."""
        out = {}
        for name in MODEL_NAMES:
            out[name] = self.models[name].state_dict()
            out[f"optimizer_{name}"] = self.optimizers[name].state_dict()
            if name in self.schedulers:
                out[f"scheduler_{name}"] = self.schedulers[name].state_dict()
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Restore what `state_dict` gives, or the part of it that `state`
        holds: a network absent from `state` keeps its weights. Where a
        network's optimizer state comes without a scheduler's (the
        reference's own checkpoints), the scheduler resumes at the
        optimizer's step, as the JAX package's schedule does on resume
        (`restore_adam_moments` in monkeynet_tpu/tasks/train.py)."""
        for name in MODEL_NAMES:
            if name not in state:
                continue
            self.models[name].load_state_dict(state[name])
            opt_state = state.get(f"optimizer_{name}")
            if opt_state is not None:
                self.optimizers[name].load_state_dict(opt_state)
            if name not in self.schedulers:
                continue
            if f"scheduler_{name}" in state:
                self.schedulers[name].load_state_dict(state[f"scheduler_{name}"])
            elif opt_state is not None and opt_state["state"]:
                self.schedulers[name].last_epoch = max(
                    int(s["step"]) for s in opt_state["state"].values()
                )
