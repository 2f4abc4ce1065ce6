"""Construct the forward path's networks from a config dict.

Counterpart of monkeynet_tpu/tasks/build.py for the generator and the
keypoint detector; the discriminator comes with the train slice.
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.models.blocks import init_parameters
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
