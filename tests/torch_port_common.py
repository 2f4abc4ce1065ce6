"""Shared fixtures for the PyTorch port's CPU tests: one tiny model config,
weights made once by the JAX package and copied into the port, and helpers
to move data between the two as numpy arrays."""

from __future__ import annotations

import copy

import numpy as np

import __graft_entry__

H = W = 32


def tiny_config():
    """__graft_entry__'s tiny config, with the covariance clip of the
    shipped configs switched on so its path is covered."""
    config = copy.deepcopy(__graft_entry__._tiny_config())
    config["model_params"]["kp_detector_params"]["clip_variance"] = 0.001
    return config


def train_config():
    """The widths of tests/test_train.py's TINY_CONFIG (16^2 frames, 3
    keypoints, 2-block networks), for the train-step tests."""
    embedding = {"use_heatmap": True, "norm_const": 10, "heatmap_type": "difference"}
    return {
        "model_params": {
            "common_params": {"num_kp": 3, "kp_variance": "matrix", "num_channels": 3},
            "kp_detector_params": {
                "temperature": 0.1, "block_expansion": 4, "max_features": 32, "num_blocks": 2,
            },
            "generator_params": {
                "block_expansion": 4, "max_features": 32, "num_blocks": 2,
                "num_refinement_blocks": 1,
                "dense_motion_params": {
                    "block_expansion": 4, "max_features": 32, "num_blocks": 2,
                    "use_mask": True, "use_correction": True,
                    "mask_embedding_params": dict(embedding, use_deformed_source_image=True),
                },
                "kp_embedding_params": dict(embedding),
            },
            "discriminator_params": {
                "kp_embedding_params": {"norm_const": 10},
                "block_expansion": 4, "max_features": 32, "num_blocks": 2,
            },
        },
        "train_params": {
            "detach_kp_generator": False,
            "detach_kp_discriminator": True,
            "num_epochs": 1,
            "epoch_milestones": [1],
            "lr": 2.0e-4,
            "batch_size": 4,
            "loss_weights": {
                "reconstruction": [10, 10, 1],
                "reconstruction_deformed": 0,
                "generator_gan": 1,
                "discriminator_gan": 1,
            },
        },
        "dataset_params": {"image_shape": [16, 16, 3]},
    }


def _randomize_batch_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_batch_stats(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def jax_variables(config, seed=0, image_hw=(H, W)):
    """(models, params, batch_stats) of the JAX package as numpy trees, with
    random running statistics and a non-zero dense-motion head, so the BN
    path and a non-identity flow are both exercised."""
    import jax

    from monkeynet_tpu.tasks.build import init_models

    models, params, batch_stats = init_models(config, jax.random.PRNGKey(seed), (*image_hw, 3))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)
    batch_stats = {k: _randomize_batch_stats(v, rng) for k, v in batch_stats.items()}
    head = params["generator"]["dense_motion"]["hourglass"]["decoder"]["final_conv"]["conv"]
    head["kernel"] = (rng.randn(*head["kernel"].shape) * 0.02).astype(np.float32)
    return models, params, batch_stats


def init_models_once():
    """The JAX package's `init_models`, initialising once and handing the
    same result to every later call with the same arguments. Its init takes
    ~20 s at the test widths on the CPU, and its train() and
    load_eval_models call it before they overwrite the weights with a
    checkpoint's. Patch it into `monkeynet_tpu.tasks.build` and into each
    module that imported it by name."""
    import jax

    from monkeynet_tpu.tasks import build as jbuild

    original, done = jbuild.init_models, {}

    def init_models(config, rng, image_shape, axis_name=None):
        key = (repr(config["model_params"]), tuple(np.asarray(jax.random.key_data(rng))
                                                   .ravel().tolist()),
               tuple(image_shape), axis_name)
        if key not in done:
            done[key] = original(config, rng, image_shape, axis_name=axis_name)
        return done[key]

    return init_models


def port_models(config, params, batch_stats):
    """The port's (generator, kp_detector) on the CPU with the JAX weights."""
    from monkeynet_tpu_torch.tasks.build import build_models
    from monkeynet_tpu_torch.utils.weights import from_jax_variables

    generator, kp_detector = build_models(config, device="cpu")
    for model, name in ((generator, "generator"), (kp_detector, "kp_detector")):
        model.load_state_dict(from_jax_variables(params[name], batch_stats[name]))
    return generator, kp_detector


def port_train_models(config, params, batch_stats):
    """The port's three networks on the CPU, in training mode, with the JAX
    weights (the discriminator has no batch statistics)."""
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.utils.weights import from_jax_variables

    models = build_train_models(config, device="cpu")
    for name, model in models.items():
        model.load_state_dict(from_jax_variables(params[name], batch_stats.get(name, {})))
    return models


def kp_to_numpy(kp):
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v) for k, v in kp.items()}


def kp_to_torch(kp):
    import torch

    return {k: torch.from_numpy(np.asarray(v)) for k, v in kp.items()}


def random_kp(rng, B, D, K, variance="matrix"):
    """Keypoints with symmetric positive-definite covariances."""
    kp = {"mean": (rng.rand(B, D, K, 2) * 2 - 1).astype(np.float32) * 0.7}
    if variance == "matrix":
        a = rng.randn(B, D, K, 2, 2).astype(np.float32) * 0.05
        kp["var"] = (np.matmul(a.transpose(0, 1, 2, 4, 3), a)
                     + 0.02 * np.eye(2, dtype=np.float32)).astype(np.float32)
    elif variance == "single":
        kp["var"] = (rng.rand(B, D, K, 1, 1) * 0.05 + 0.01).astype(np.float32)
    return kp
