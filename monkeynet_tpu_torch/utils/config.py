"""YAML config loading and validation.

The schema is the reference's per-dataset YAML (configs/*.yaml):
dataset_params / model_params (common, kp_detector, generator, discriminator)
/ train_params / reconstruction_params / transfer_params / prediction_params
/ visualizer_params, splatted as kwargs into the model constructors.
"""

from __future__ import annotations

import os
from shutil import copy

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


def prepare_log_dir(config_path: str, log_dir: str, checkpoint: str | None) -> str:
    """A timestamped log dir (or the checkpoint's dir when resuming), with
    the config copied in for provenance (reference run.py:39-48)."""
    from time import gmtime, strftime

    if checkpoint is not None:
        out = os.path.dirname(checkpoint)
    else:
        base = os.path.basename(config_path).split(".")[0]
        out = os.path.join(log_dir, base + " " + strftime("%d-%m-%y %H:%M:%S", gmtime()))
    os.makedirs(out, exist_ok=True)
    dst = os.path.join(out, os.path.basename(config_path))
    if not os.path.exists(dst):
        copy(config_path, out)
    return out
