"""Construct the networks from a config dict.

Counterpart of monkeynet_tpu/tasks/build.py: `build_models` gives the
forward path's generator and keypoint detector in eval mode;
`build_train_models` gives all three networks in training mode. The JAX
package's `axis_name` has no counterpart here: the Trainer that steps the
networks sets the process group their batch norms reduce over
(tasks/train.py).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from monkeynet_tpu_torch.models.blocks import init_parameters
from monkeynet_tpu_torch.models.discriminator import Discriminator
from monkeynet_tpu_torch.models.generator import MotionTransferGenerator
from monkeynet_tpu_torch.models.kp_detector import KPDetector
from monkeynet_tpu_torch.utils.device import require_device


def build_models(config: dict, device="cuda", seed: int = 0):
    """(generator, kp_detector) in eval mode on `device`, initialised from
    torch.Generators seeded with `seed`. Raises if `device` is CUDA and no
    card is present."""
    device = require_device(device)
    mp = config["model_params"]
    common = mp["common_params"]
    generator = MotionTransferGenerator(**mp["generator_params"], **common)
    kp_detector = KPDetector(**mp["kp_detector_params"], **common)
    init_parameters(generator, torch.Generator().manual_seed(seed))
    init_parameters(kp_detector, torch.Generator().manual_seed(seed + 1))
    return generator.to(device).eval(), kp_detector.to(device).eval()


def build_discriminator(config: dict, device="cuda", seed: int = 0) -> Discriminator:
    """The discriminator in eval mode on `device`, seeded like the others."""
    device = require_device(device)
    mp = config["model_params"]
    discriminator = Discriminator(**mp["discriminator_params"], **mp["common_params"])
    init_parameters(discriminator, torch.Generator().manual_seed(seed + 2))
    return discriminator.to(device).eval()


def build_train_models(config: dict, device="cuda", seed: int = 0) -> Dict[str, nn.Module]:
    """{'generator', 'discriminator', 'kp_detector'} in training mode on
    `device`; the generator and the keypoint detector are `build_models`'s
    (the discriminator has no batch norm)."""
    generator, kp_detector = build_models(config, device, seed)
    models = {
        "generator": generator,
        "discriminator": build_discriminator(config, device, seed),
        "kp_detector": kp_detector,
    }
    for model in models.values():
        model.train()
    return models
