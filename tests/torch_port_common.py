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


def jax_variables(config, seed=0):
    """(models, params, batch_stats) of the JAX package as numpy trees, with
    random running statistics and a non-zero dense-motion head, so the BN
    path and a non-identity flow are both exercised."""
    import jax

    from monkeynet_tpu.tasks.build import init_models

    models, params, batch_stats = init_models(config, jax.random.PRNGKey(seed), (H, W, 3))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)
    batch_stats = {k: _randomize_batch_stats(v, rng) for k, v in batch_stats.items()}
    head = params["generator"]["dense_motion"]["hourglass"]["decoder"]["final_conv"]["conv"]
    head["kernel"] = (rng.randn(*head["kernel"].shape) * 0.02).astype(np.float32)
    return models, params, batch_stats


def port_models(config, params, batch_stats):
    """The port's (generator, kp_detector) on the CPU with the JAX weights."""
    from monkeynet_tpu_torch.tasks.build import build_models
    from monkeynet_tpu_torch.utils.weights import from_jax_variables

    generator, kp_detector = build_models(config, device="cpu")
    for model, name in ((generator, "generator"), (kp_detector, "kp_detector")):
        model.load_state_dict(from_jax_variables(params[name], batch_stats[name]))
    return generator, kp_detector


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
