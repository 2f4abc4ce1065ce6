"""The GAN train step in plain PyTorch, float32: the benchmark's reference.

Monkey-Net's objective (Siarohin et al., CVPR 2019, and its train.py): the
keypoint detector runs on the source and driving frames together, the
generator animates the source; the generator's loss is the feature-matching
L1 between the discriminator's maps of real and generated frames (level 0 is
the pixels), each level weighted, plus the LSGAN term (1 - D(fake))^2, with
the discriminator's parameters held; the discriminator's loss is
(1 - D(real))^2 + D(fake)^2 on the generated frames detached and, with
`detach_kp_discriminator`, the keypoints detached. Each network steps its own
Adam (betas 0.5 and 0.999, eps 1e-8) from the gradients at the step's
starting parameters.

`half_batch` takes every per-sample mean over the first half of the batch
only: one of the faults the benchmark's tests plant to see the comparison
fail.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.func import functional_call

NAMES = ("generator", "discriminator", "kp_detector")


def _split(kp, detach):
    f = (lambda v: v.detach()) if detach else (lambda v: v)
    return ({k: f(v[:, 1:]) for k, v in kp.items()}, {k: f(v[:, :1]) for k, v in kp.items()})


def _mean(v, half):
    v = v.reshape(v.shape[0], -1).mean(dim=1)
    return (v[: v.shape[0] // 2] if half else v).mean()


def objective(nets, params, batch, train_params, half_batch=False):
    """(loss_G + loss_D, [each loss's batch mean], the generated frames, the
    joined keypoints' means) at `params`."""
    weights = train_params["loss_weights"]
    source, video = batch["source"], batch["video"]
    kp = functional_call(nets["kp_detector"], params["kp_detector"],
                         (torch.cat([source, video], dim=1),))
    kp_driving, kp_source = _split(kp, train_params["detach_kp_generator"])
    out = functional_call(nets["generator"], params["generator"], (source, kp_driving, kp_source))
    fake = out["video_prediction"]

    def disc(p, frames, detach_kp):
        kd, ks = _split(kp, detach_kp)
        return functional_call(nets["discriminator"], p, (frames, kd, ks))

    held = {k: v.detach() for k, v in params["discriminator"].items()}
    maps_fake, maps_real = disc(held, fake, False), disc(held, video, False)
    losses = []
    if weights["reconstruction_deformed"]:
        losses.append(weights["reconstruction_deformed"]
                      * _mean(torch.abs(maps_real[0] - out["video_deformed"]), half_batch))
    for i, (r, f) in enumerate(zip(maps_real[:-1], maps_fake[:-1])):
        if weights["reconstruction"][i]:
            losses.append(weights["reconstruction"][i] * _mean(torch.abs(f - r), half_batch))
    losses.append(weights["generator_gan"] * _mean((1.0 - maps_fake[-1]) ** 2, half_batch))
    detach = train_params["detach_kp_discriminator"]
    d_fake = disc(params["discriminator"], fake.detach(), detach)
    d_real = disc(params["discriminator"], video, detach)
    losses.append(weights["discriminator_gan"]
                  * _mean((1.0 - d_real[-1]) ** 2 + d_fake[-1] ** 2, half_batch))
    return sum(losses), losses, fake, kp["mean"]


class Adam:
    """torch.optim.Adam's update, written out: m, v, bias corrections."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas=(0.5, 0.999), eps=1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        b1, b2 = self.betas
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))


def train_steps(nets, state: Dict[str, Dict[str, torch.Tensor]], batches: List[Dict],
                train_params, half_batch=False):
    """Steps over `batches` ({'source', 'video'} float in [0, 1]) from
    `state` (state_dicts). Returns (losses [step][term] floats, the first
    step's gradients {net: {name: tensor}}, the parameters after the last
    step {net: {name: tensor}}, the first step's generated frames and
    keypoint means)."""
    params, opts = {}, {}
    for name in NAMES:
        nets[name].load_state_dict(state[name])
        nets[name].train()
        params[name] = {k: p.detach().clone().requires_grad_()
                        for k, p in nets[name].named_parameters()}
        opts[name] = Adam(params[name], train_params["lr"])
    losses, first, outputs = [], None, None
    for batch in batches:
        flat = [p for name in NAMES for p in params[name].values()]
        total, terms, fake, kp_mean = objective(nets, params, batch, train_params, half_batch)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = iter(torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads))
        by_net = {name: {k: next(grads) for k in params[name]} for name in NAMES}
        for name in NAMES:
            opts[name].step(params[name], by_net[name])
        losses.append([float(t.detach()) for t in terms])
        if first is None:
            first, outputs = by_net, (fake.detach(), kp_mean.detach())
    return (losses, first, {n: {k: p.detach() for k, p in params[n].items()} for n in NAMES},
            outputs)
