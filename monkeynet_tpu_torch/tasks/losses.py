"""LSGAN and feature-matching losses.

Counterpart of monkeynet_tpu/tasks/losses.py: per-batch-element means; the
generator loss is an optional deformed-reconstruction L1, a per-level L1
between the discriminator's maps of real and generated video (level 0 is
the pixels), and the LSGAN term (1 - D(fake))^2; the discriminator loss is
(1 - D(real))^2 + D(fake)^2. The lists keep the reference's order, so log
names line up.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def mean_batch(val):
    """Per-sample mean: (B, ...) -> (B,)."""
    return val.reshape(val.shape[0], -1).mean(dim=-1)


def reconstruction_loss(prediction, target, weight):
    if weight == 0:
        return None
    return weight * mean_batch(torch.abs(prediction - target))


def generator_gan_loss(discriminator_maps_generated, weight):
    score = (1.0 - discriminator_maps_generated[-1]) ** 2
    return weight * mean_batch(score)


def discriminator_gan_loss(discriminator_maps_generated, discriminator_maps_real, weight):
    score = (1.0 - discriminator_maps_real[-1]) ** 2 + discriminator_maps_generated[-1] ** 2
    return weight * mean_batch(score)


def generator_loss_names(loss_weights: Dict) -> List[str]:
    names = []
    if loss_weights["reconstruction_deformed"] != 0:
        names.append("rec_def")
    if loss_weights["reconstruction"] is not None:
        for i, w in enumerate(loss_weights["reconstruction"]):
            if w == 0:
                continue
            names.append(f"layer-{i}_rec")
    names.append("gen_gan")
    return names


def discriminator_loss_names() -> List[str]:
    return ["disc_gan"]


def generator_loss(discriminator_maps_generated: Sequence, discriminator_maps_real: Sequence,
                   video_deformed, loss_weights: Dict) -> List:
    """The list of per-sample (B,) loss vectors, in the reference's order."""
    values = []
    if loss_weights["reconstruction_deformed"] != 0:
        values.append(
            reconstruction_loss(
                discriminator_maps_real[0], video_deformed,
                loss_weights["reconstruction_deformed"],
            )
        )
    if loss_weights["reconstruction"] is not None:
        for i, (real, fake) in enumerate(
            zip(discriminator_maps_real[:-1], discriminator_maps_generated[:-1])
        ):
            w = loss_weights["reconstruction"][i]
            if w == 0:
                continue
            values.append(reconstruction_loss(fake, real, w))
    values.append(
        generator_gan_loss(discriminator_maps_generated, loss_weights["generator_gan"])
    )
    return values


def discriminator_loss(discriminator_maps_generated: Sequence,
                       discriminator_maps_real: Sequence, loss_weights: Dict) -> List:
    return [
        discriminator_gan_loss(
            discriminator_maps_generated, discriminator_maps_real,
            loss_weights["discriminator_gan"],
        )
    ]
