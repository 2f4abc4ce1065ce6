"""The PyTorch port against the JAX package at the model options of the 256^2
configs (vox, shapes-256, vox-full, moving-gif), at tiny widths: the keypoint
detector and generator forward, and one GAN train step.

The options, each alone and all together:
  * `scale_factor: 0.25` in the keypoint detector, the dense motion and the
    keypoint embedding (the frames are resized before the hourglass);
  * the generator's `interpolation_mode: trilinear`;
  * a generator deeper than its dense motion (4 blocks against 3; vox-full's
    7 against 5).

The weights are drawn with numpy from the JAX package's variable shapes
(`jax.eval_shape`, no JAX init to compile): kernels from torch's default
U(+-1/sqrt(fan_in)) as the JAX package's init draws them, random norm
scales, biases and running statistics, and a dense-motion head that is not
zero, so the flow is not the identity. Tolerances are those of
test_torch_port_models.py (forward) and test_torch_port_train.py (the step).
"""

from __future__ import annotations

import copy

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from monkeynet_tpu.tasks.build import build_models as jbuild_models
from monkeynet_tpu.tasks.build import init_models

from .test_torch_port_models import OUT_ATOL
from .test_torch_port_train import _assert_updates_match, _jax_step, _port_step, _sgd
from .torch_port_common import (
    _randomize_batch_stats,
    kp_to_torch,
    port_models,
    random_kp,
    tiny_config,
    train_config,
)


def _options(config, names):
    gp = config["model_params"]["generator_params"]
    if "scale_factor" in names:
        config["model_params"]["kp_detector_params"]["scale_factor"] = 0.25
        gp["dense_motion_params"]["scale_factor"] = 0.25
        gp["kp_embedding_params"]["scale_factor"] = 0.25
    if "trilinear" in names:
        gp["interpolation_mode"] = "trilinear"
    if "deep_generator" in names:
        gp["num_blocks"] = gp["dense_motion_params"]["num_blocks"] + 1
    return config


CASES = {
    "scale_factor": ("scale_factor",),
    "trilinear": ("trilinear",),
    "deep_generator": ("deep_generator",),
    "all": ("scale_factor", "trilinear", "deep_generator"),
}


def _random_variables(config, hw, seed):
    """(models, params, batch_stats) of the JAX package with numpy-drawn
    values in the shapes its init would give."""
    params, batch_stats = jax.eval_shape(
        lambda k: init_models(config, k, (hw, hw, 3))[1:], jax.random.PRNGKey(0)
    )
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":  # torch's default, as the JAX package's init
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.9, 1.1, leaf.shape).astype(np.float32)
        return rng.uniform(-0.05, 0.05, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, params)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), batch_stats)
    batch_stats = {k: _randomize_batch_stats(v, rng) for k, v in zeros.items()}
    head = params["generator"]["dense_motion"]["hourglass"]["decoder"]["final_conv"]["conv"]
    head["kernel"] = (rng.randn(*head["kernel"].shape) * 0.02).astype(np.float32)
    generator, discriminator, kp_detector = jbuild_models(config)
    models = {"generator": generator, "discriminator": discriminator, "kp_detector": kp_detector}
    return models, params, batch_stats


FORWARD_HW = 64


@pytest.fixture(scope="module", params=sorted(CASES))
def forward_case(request):
    config = _options(tiny_config(), CASES[request.param])
    models, params, batch_stats = _random_variables(config, FORWARD_HW, seed=11)
    generator, kp_detector = port_models(config, params, batch_stats)
    return request.param, config, models, params, batch_stats, generator, kp_detector


def test_options_forward_matches_jax(forward_case):
    """The keypoint detector on 3 frames and the generator on 2 driving
    frames, in eval mode, to the forward tolerances of
    test_torch_port_models.py."""
    name, config, models, params, batch_stats, generator, kp_detector = forward_case
    rng = np.random.RandomState(12)
    video = rng.rand(1, 3, FORWARD_HW, FORWARD_HW, 3).astype(np.float32)
    want = jax.jit(models["kp_detector"].apply, static_argnums=2)(
        {"params": params["kp_detector"], "batch_stats": batch_stats["kp_detector"]},
        jnp.asarray(video), False,
    )
    with torch.no_grad():
        got = kp_detector(torch.from_numpy(video))
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(want["mean"]), atol=1e-5)
    np.testing.assert_allclose(got["var"].numpy(), np.asarray(want["var"]), atol=1e-4, rtol=1e-4)

    source = rng.rand(1, 1, FORWARD_HW, FORWARD_HW, 3).astype(np.float32)
    kp_d, kp_s = random_kp(rng, 1, 2, 4), random_kp(rng, 1, 1, 4)
    want = jax.jit(models["generator"].apply, static_argnums=4)(
        {"params": params["generator"], "batch_stats": batch_stats["generator"]},
        jnp.asarray(source), kp_d, kp_s, False,
    )
    with torch.no_grad():
        got = generator(torch.from_numpy(source), kp_to_torch(kp_d), kp_to_torch(kp_s))
    assert np.abs(np.asarray(want["video_deformed"]) - source).max() > 0.05  # warped off-grid
    for key in ("video_prediction", "video_deformed"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=OUT_ATOL,
                                   err_msg=f"{name}: {key}")


STEP_HW = 32


def test_options_train_step_matches_jax():
    """One SGD(1.0) step with every option on, at the widths of
    test_torch_port_train.py (torch_port_common.train_config), batch 4 at
    32^2: metrics, the generator's outputs, every updated parameter and the
    running statistics, to that file's tolerances.

    The options are not stepped one by one. Without the scale factor the
    keypoint detector sees the whole 32^2 frame, and there f32 rounding is
    amplified until the JAX package's step differs from the same step in
    float64 (`jax_enable_x64`) by more than these tolerances, while the
    port's stays close to its own float64 step. With the scale factor the
    detector sees 8^2, and both packages' steps with all three options agree
    with the port's float64 step and with each other."""
    config = _options(train_config(), CASES["all"])
    models, params, batch_stats = _random_variables(config, STEP_HW, seed=13)
    rng = np.random.RandomState(14)
    batch = {k: rng.rand(4, 1, STEP_HW, STEP_HW, 3).astype(np.float32)
             for k in ("source", "video")}
    shared = (config, models, params, batch_stats, batch)
    tp = copy.deepcopy(config["train_params"])
    want_after, want_out = _jax_step(shared, tp, optax.sgd(1.0))
    before, got_after, got_out = _port_step(shared, tp, _sgd)
    np.testing.assert_allclose(got_out["metrics"].numpy(), np.asarray(want_out["metrics"]),
                               rtol=1e-4, atol=1e-5)
    for key in ("video_prediction", "video_deformed"):
        np.testing.assert_allclose(got_out[key].numpy(), np.asarray(want_out[key]), atol=1e-4)
    np.testing.assert_allclose(got_out["kp_joined"]["mean"].numpy(),
                               np.asarray(want_out["kp_joined"]["mean"]), atol=1e-5)
    _assert_updates_match(before, got_after, want_after)
