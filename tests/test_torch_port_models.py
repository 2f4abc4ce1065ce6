"""The PyTorch port's keypoint detector, generator, Animator and the whole
TransferEngine slice, held against the JAX package on the CPU with shared
weights (the blocks and sub-modules: test_torch_port_blocks.py).

Weights are made by the JAX package, with random batch-norm running
statistics, and copied into the port through `from_jax_variables`. The
dense-motion head gets small random weights so the flow is not the
identity and the warps sample off-grid.

Tolerances (f32 on both sides): each conv sums in another order, so values
drift by f32 ulps per layer. Outputs in [0, 1] are held to 1e-4 absolute;
the measured gap on this config is ~1e-6. Keypoint means and covariances
are held to 1e-5 and 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from monkeynet_tpu.tasks import animate as janimate
from monkeynet_tpu_torch.tasks import animate as tanimate

from .torch_port_common import (
    H,
    W,
    jax_variables,
    kp_to_torch,
    port_models,
    random_kp,
    tiny_config,
)

OUT_ATOL = 1e-4


@pytest.fixture(scope="module")
def shared():
    config = tiny_config()
    models, params, batch_stats = jax_variables(config)
    generator, kp_detector = port_models(config, params, batch_stats)
    return config, models, params, batch_stats, generator, kp_detector


@pytest.fixture(scope="module")
def clip_data():
    rng = np.random.RandomState(0)
    return {
        "source": rng.rand(1, 1, H, W, 3).astype(np.float32),
        "driving": rng.rand(1, 5, H, W, 3).astype(np.float32),
    }


def test_kp_detector_matches_jax(shared, clip_data):
    config, models, params, batch_stats, _, kp_detector = shared
    video = clip_data["driving"]
    want = jax.jit(models["kp_detector"].apply, static_argnums=2)(
        {"params": params["kp_detector"], "batch_stats": batch_stats["kp_detector"]},
        jnp.asarray(video), False,
    )
    with torch.no_grad():
        got = kp_detector(torch.from_numpy(video))
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(want["mean"]), atol=1e-5)
    np.testing.assert_allclose(got["var"].numpy(), np.asarray(want["var"]), atol=1e-4, rtol=1e-4)


def test_generator_matches_jax(shared):
    config, models, params, batch_stats, generator, _ = shared
    rng = np.random.RandomState(7)
    source = rng.rand(1, 1, H, W, 3).astype(np.float32)
    kp_d, kp_s = random_kp(rng, 1, 3, 4), random_kp(rng, 1, 1, 4)
    want = jax.jit(models["generator"].apply, static_argnums=4)(
        {"params": params["generator"], "batch_stats": batch_stats["generator"]},
        jnp.asarray(source), kp_d, kp_s, False,
    )
    with torch.no_grad():
        got = generator(torch.from_numpy(source), kp_to_torch(kp_d), kp_to_torch(kp_s))
    for key in ("video_prediction", "video_deformed"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=OUT_ATOL)


def _jax_engine_out(shared, clip_data, chunk, d):
    config, models, params, batch_stats, _, _ = shared
    engine = janimate.TransferEngine(
        models["generator"], models["kp_detector"],
        {"params": params["generator"], "batch_stats": batch_stats["generator"]},
        {"params": params["kp_detector"], "batch_stats": batch_stats["kp_detector"]},
        chunk=chunk,
    )
    return engine(jnp.asarray(clip_data["source"]), jnp.asarray(clip_data["driving"][:, :d]))


@pytest.mark.parametrize("chunk,d", [(16, 5), (16, 20)])
def test_transfer_engine_matches_jax(shared, clip_data, chunk, d):
    """The whole slice: kp detection of source and driving frames, the
    move_location normalisation across chunks, and generation. (16, 20)
    runs two chunks, the second padded to its bucket."""
    if d > clip_data["driving"].shape[1]:
        rng = np.random.RandomState(8)
        clip_data = dict(clip_data, driving=rng.rand(1, d, H, W, 3).astype(np.float32))
    want = _jax_engine_out(shared, clip_data, chunk, d)
    _, _, _, _, generator, kp_detector = shared
    engine = tanimate.TransferEngine(generator, kp_detector, chunk=chunk, device="cpu")
    got = engine(torch.from_numpy(clip_data["source"]), torch.from_numpy(clip_data["driving"][:, :d]))
    assert got["video_prediction"].shape == (1, d, H, W, 3)
    source = clip_data["source"]
    assert np.abs(np.asarray(want["video_deformed"]) - source).max() > 0.1  # warped off-grid
    for key in ("video_prediction", "video_deformed"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=OUT_ATOL)
    for group in ("kp_driving", "kp_norm"):
        np.testing.assert_allclose(
            got[group]["mean"].numpy(), np.asarray(want[group]["mean"]), atol=1e-5
        )
        np.testing.assert_allclose(
            got[group]["var"].numpy(), np.asarray(want[group]["var"]), atol=1e-4, rtol=1e-4
        )
    np.testing.assert_allclose(
        got["kp_source"]["mean"].numpy(), np.asarray(want["kp_source"]["mean"]), atol=1e-5
    )


def test_animator_matches_jax(shared):
    config, models, params, batch_stats, generator, _ = shared
    rng = np.random.RandomState(9)
    source = rng.rand(1, 1, H, W, 3).astype(np.float32)
    kp_d, kp_s = random_kp(rng, 1, 18, 4), random_kp(rng, 1, 1, 4)
    want = janimate.Animator(
        models["generator"],
        {"params": params["generator"], "batch_stats": batch_stats["generator"]}, chunk=16,
    )(source, kp_d, kp_s)
    got = tanimate.Animator(generator, chunk=16, device="cpu")(
        torch.from_numpy(source), kp_to_torch(kp_d), kp_to_torch(kp_s)
    )
    for key in ("video_prediction", "video_deformed"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=OUT_ATOL)


def test_transfer_engine_bf16_close_to_f32(shared, clip_data):
    """dtype=bfloat16 keeps kp math and grids f32 and returns f32 outputs.
    bf16 keeps 8 mantissa bits, so the frames may differ from the f32 run by
    a few bf16 ulps of 1 (2^-8 each) after ~20 layers; the mean gap must stay
    under 1e-2 and keypoints within 2e-2 of the f32 ones."""
    _, _, _, _, generator, kp_detector = shared
    src, drv = torch.from_numpy(clip_data["source"]), torch.from_numpy(clip_data["driving"])
    ref = tanimate.TransferEngine(generator, kp_detector, chunk=16, device="cpu")(src, drv)
    out = tanimate.TransferEngine(
        generator, kp_detector, chunk=16, dtype=torch.bfloat16, device="cpu"
    )(src, drv)
    assert next(generator.parameters()).dtype == torch.float32  # caller's model untouched
    pred = out["video_prediction"]
    assert pred.dtype == torch.float32 and torch.isfinite(pred).all()
    assert out["kp_driving"]["mean"].dtype == torch.float32
    assert (pred - ref["video_prediction"]).abs().mean() < 1e-2
    assert (out["kp_driving"]["mean"] - ref["kp_driving"]["mean"]).abs().max() < 2e-2


def test_split_kp():
    kp = {"mean": torch.arange(12.0).reshape(1, 3, 2, 2)}
    parts = tanimate.split_kp(kp)
    assert torch.equal(parts["kp_source"]["mean"], kp["mean"][:, :1])
    assert torch.equal(parts["kp_driving"]["mean"], kp["mean"][:, 1:])


@pytest.mark.parametrize("n,chunk,want", [(5, 128, 16), (16, 128, 16), (17, 128, 32),
                                          (200, 128, 128), (100, 96, 96)])
def test_bucket_matches_jax(n, chunk, want):
    assert tanimate._bucket(n, chunk) == janimate._bucket(n, chunk) == want
