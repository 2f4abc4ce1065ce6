"""The system under test: monkeynet_tpu_torch, as the benchmark builds it.

The only module of the benchmark that imports the program. It makes the
program's networks with the benchmark's seeded state_dicts (no weights of
the program's own draw), and hands over its transfer engine and its trainer.
"""

from __future__ import annotations

from typing import Dict

import torch


def networks(model_params: Dict, state: Dict[str, Dict], device, names=("kp_detector",
             "generator", "discriminator")) -> Dict[str, torch.nn.Module]:
    """The program's networks of `names`, made on `device` and loaded with
    `state`."""
    from monkeynet_tpu_torch.models.discriminator import Discriminator
    from monkeynet_tpu_torch.models.generator import MotionTransferGenerator
    from monkeynet_tpu_torch.models.kp_detector import KPDetector

    common = model_params["common_params"]
    make = {"kp_detector": lambda: KPDetector(**model_params["kp_detector_params"], **common),
            "generator": lambda: MotionTransferGenerator(**model_params["generator_params"],
                                                         **common),
            "discriminator": lambda: Discriminator(**model_params["discriminator_params"],
                                                   **common)}
    out = {}
    with torch.device(device):
        for name in names:
            net = make[name]()
            net.load_state_dict(state[name])
            out[name] = net
    return out


def transfer_engine(model_params: Dict, state: Dict, device, chunk: int, dtype):
    """The program's TransferEngine (relative move_location transfer)."""
    from monkeynet_tpu_torch.tasks.animate import TransferEngine

    nets = networks(model_params, state, device, ("kp_detector", "generator"))
    return TransferEngine(nets["generator"].eval(), nets["kp_detector"].eval(), chunk=chunk,
                          dtype=dtype, move_location=True, device=device)


def trainer(model_params: Dict, train_params: Dict, state: Dict, device, steps_per_epoch: int):
    """The program's Trainer over its three networks."""
    from monkeynet_tpu_torch.tasks.train import Trainer

    return Trainer(networks(model_params, state, device), train_params, device=device,
                   steps_per_epoch=steps_per_epoch)
