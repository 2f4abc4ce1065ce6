"""YAML config loading and validation.

The schema is the reference's per-dataset YAML (configs/*.yaml):
dataset_params / model_params (common, kp_detector, generator, discriminator)
/ train_params / reconstruction_params / transfer_params / prediction_params
/ visualizer_params, splatted as kwargs into the model constructors.
"""

from __future__ import annotations

import yaml


def load_config(path: str) -> dict:
    with open(path) as f:
        config = yaml.safe_load(f)
    validate_config(config)
    return config


def validate_config(config: dict) -> None:
    blocks_discriminator = config["model_params"]["discriminator_params"]["num_blocks"]
    rec = config["train_params"]["loss_weights"]["reconstruction"]
    if rec is not None and len(rec) != blocks_discriminator + 1:
        raise ValueError(
            "loss_weights.reconstruction must have discriminator num_blocks + 1 "
            f"entries (got {len(rec)}, want {blocks_discriminator + 1})"
        )
