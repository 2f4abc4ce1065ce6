"""The PyTorch port's train slice held against the JAX package on the CPU:
InstanceNorm, batch-norm gradients, the discriminator, the losses, the
learning-rate schedule, and one whole GAN train step.

Weights are made by the JAX package and copied into the port through
`from_jax_variables`; inputs come from numpy with fixed seeds. The config is
the tiny one of tests/test_train.py (16^2 frames), batch 4.

Tolerances (f32 on both sides, other summation orders): forward values to
1e-5; one SGD(1.0) step moves every parameter by exactly its gradient, and
the gradients of this step reach ~2 (the keypoint detector sits behind a
temperature-0.1 softmax), so a tensor's update is held to 2e-4 of its
largest entry (at least 2e-4 absolute), the bound tests/test_train.py uses
for the same step across device layouts.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from monkeynet_tpu.models import blocks as jblocks
from monkeynet_tpu.tasks import losses as jlosses
from monkeynet_tpu.tasks import train as jtrain
from monkeynet_tpu.utils.torch_import import import_state_dict
from monkeynet_tpu_torch.models import blocks as tblocks
from monkeynet_tpu_torch.tasks import losses as tlosses
from monkeynet_tpu_torch.tasks import train as ttrain
from monkeynet_tpu_torch.tasks.build import build_discriminator, build_train_models
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import (
    jax_variables,
    kp_to_torch,
    port_train_models,
    random_kp,
    train_config,
)

HW = 16
MODEL_NAMES = ("generator", "discriminator", "kp_detector")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---- modules ---------------------------------------------------------------

def test_instance_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 2, 6, 5, 7) * 2.0 + 0.5).astype(np.float32)
    params = {"scale": rng.rand(7).astype(np.float32) + 0.5,
              "bias": rng.randn(7).astype(np.float32)}
    dout = rng.randn(*x.shape).astype(np.float32)
    jnorm = jblocks.InstanceNorm(7)
    want, vjp = jax.vjp(lambda p, v: jnorm.apply({"params": p}, v), params, jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(dout))
    tnorm = tblocks.InstanceNorm(7)
    tnorm.load_state_dict(from_jax_variables(params, {}))
    tx = _t(x).requires_grad_()
    got = tnorm(tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    got.backward(_t(dout))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), atol=1e-5)
    # the affine gradients sum 120 values per channel
    np.testing.assert_allclose(tnorm.weight.grad.numpy(), np.asarray(want_dp["scale"]), atol=1e-4)
    np.testing.assert_allclose(tnorm.bias.grad.numpy(), np.asarray(want_dp["bias"]), atol=1e-4)


def test_batchnorm_train_gradient_matches_jax():
    """In training mode the gradient flows through the batch mean and
    variance, as in the JAX package."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 2, 4, 4, 6) * 3.0 + 1.0).astype(np.float32)
    dout = rng.randn(*x.shape).astype(np.float32)
    jbn = jblocks.SyncBatchNorm(6)
    variables = _np_tree(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), False))

    def loss(v):
        y, _ = jbn.apply(variables, v, True, mutable=["batch_stats"])
        return jnp.sum(y * dout)

    want = jax.grad(loss)(jnp.asarray(x))
    tbn = tblocks.SyncBatchNorm(6).train()
    tx = _t(x).requires_grad_()
    tbn(tx).backward(_t(dout))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-5)
    # through the statistics the gradient of each channel sums to zero;
    # with them held constant it would sum to sum(dout) / std instead
    assert tx.grad.sum(dim=(0, 1, 2, 3)).abs().max() < 1e-4


@pytest.fixture(scope="module")
def shared():
    config = train_config()
    models, params, batch_stats = jax_variables(config, image_hw=(HW, HW))
    rng = np.random.RandomState(0)
    batch = {"source": rng.rand(4, 1, HW, HW, 3).astype(np.float32),
             "video": rng.rand(4, 1, HW, HW, 3).astype(np.float32)}
    return config, models, params, batch_stats, batch


def test_discriminator_maps_match_jax(shared):
    config, models, params, batch_stats, batch = shared
    kp_d, kp_s = random_kp(np.random.RandomState(2), 4, 1, 3), \
        random_kp(np.random.RandomState(3), 4, 1, 3)
    want = models["discriminator"].apply(
        {"params": params["discriminator"]}, jnp.asarray(batch["video"]), kp_d, kp_s
    )
    disc = port_train_models(config, params, batch_stats)["discriminator"]
    got = disc(_t(batch["video"]), kp_to_torch(kp_d), kp_to_torch(kp_s))
    assert len(got) == len(want) == 4  # [x, feat_1, feat_2, score]
    assert got[-1].shape[-1] == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5)


def test_discriminator_state_dict_round_trips_through_torch_import(shared):
    """The JAX package's importer of reference checkpoints consumes every key
    of the port's discriminator state_dict and fills every JAX variable."""
    config, _, params, _, _ = shared
    disc = build_discriminator(config, device="cpu", seed=4)
    sd = {k: v.numpy() for k, v in disc.state_dict().items()}
    assert "down_blocks.1.norm.weight" in sd and "conv.weight" in sd
    assert not any(k.startswith("kp_embedding") for k in sd)
    template = jax.tree.map(np.zeros_like, {"params": params["discriminator"]})
    imported = import_state_dict(template, sd)  # raises on any unmatched key
    back = from_jax_variables(imported["params"], {})
    assert set(back) == set(sd)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)


# ---- losses and schedule ---------------------------------------------------

_WEIGHTS = {
    "taichi": {"reconstruction": [10, 10, 1], "reconstruction_deformed": 0,
               "generator_gan": 1, "discriminator_gan": 1},
    "deformed": {"reconstruction": [10, 0, 1], "reconstruction_deformed": 5,
                 "generator_gan": 2, "discriminator_gan": 3},
    "no_reconstruction": {"reconstruction": None, "reconstruction_deformed": 0,
                          "generator_gan": 1, "discriminator_gan": 1},
}


@pytest.mark.parametrize("name", sorted(_WEIGHTS))
def test_losses_match_jax(name):
    weights = _WEIGHTS[name]
    rng = np.random.RandomState(5)
    shapes = [(3, 2, 8, 8, 3), (3, 2, 2, 2, 8), (3, 2, 1, 1, 16), (3, 2, 1, 1, 1)]
    fake = [rng.randn(*s).astype(np.float32) for s in shapes]
    real = [rng.randn(*s).astype(np.float32) for s in shapes]
    deformed = rng.randn(*shapes[0]).astype(np.float32)
    want_g = jlosses.generator_loss(fake, real, deformed, weights)
    got_g = tlosses.generator_loss([_t(a) for a in fake], [_t(a) for a in real],
                                   _t(deformed), weights)
    want_d = jlosses.discriminator_loss(fake, real, weights)
    got_d = tlosses.discriminator_loss([_t(a) for a in fake], [_t(a) for a in real], weights)
    names = tlosses.generator_loss_names(weights)
    assert names == jlosses.generator_loss_names(weights)
    assert tlosses.discriminator_loss_names() == jlosses.discriminator_loss_names()
    assert len(got_g) == len(want_g) == len(names) and len(got_d) == len(want_d) == 1
    for g, w in zip(got_g + got_d, want_g + want_d):
        assert g.shape == (3,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert ttrain.metric_names({"loss_weights": weights}) == \
        jtrain.metric_names({"loss_weights": weights})


def test_multistep_lr_matches_jax_and_the_scheduler():
    """The schedule function against the JAX one around the milestones, and
    the MultiStepLR that `make_optimizer` builds against the function."""
    milestones, spe, base = [3, 5], 7, 2e-4
    want = jtrain.multistep_lr(base, milestones, spe)
    got = ttrain.multistep_lr(base, milestones, spe)
    steps = [0, 1, 20, 21, 22, 34, 35, 36, 100]
    for step in steps:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=str(step))
    assert got(20) == base and got(21) == pytest.approx(base * 0.1)
    param = torch.nn.Parameter(torch.zeros(1))
    optimizer, scheduler = ttrain.make_optimizer(
        [param], {"lr": base, "epoch_milestones": milestones}, spe
    )
    assert optimizer.defaults["betas"] == (0.5, 0.999) and optimizer.defaults["eps"] == 1e-8
    for step in range(40):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(got(step), rel=1e-9)
        optimizer.step()
        scheduler.step()


def test_split_kp_detaches_on_request():
    kp = {"mean": torch.arange(12.0).reshape(1, 3, 2, 2).requires_grad_()}
    kept, cut = ttrain.split_kp(kp, False), ttrain.split_kp(kp, True)
    assert torch.equal(kept["kp_source"]["mean"], kp["mean"][:, :1])
    assert torch.equal(cut["kp_driving"]["mean"], kp["mean"][:, 1:])
    assert kept["kp_driving"]["mean"].requires_grad
    assert not cut["kp_driving"]["mean"].requires_grad
    assert not cut["kp_source"]["mean"].requires_grad


# ---- the slice as a whole --------------------------------------------------

def _jax_step(shared, train_params, optimizer):
    _, models, params, batch_stats, batch = shared
    state = jtrain.create_train_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch_stats), optimizer
    )
    step = jax.jit(jtrain.make_train_step(models, train_params, optimizer))
    new_state, out = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    after = {
        name: from_jax_variables(_np_tree(new_state.params[name]),
                                 _np_tree(new_state.batch_stats.get(name, {})))
        for name in MODEL_NAMES
    }
    return after, out


def _port_step(shared, train_params, optimizer_factory, batch=None):
    config, _, params, batch_stats, default_batch = shared
    models = port_train_models(config, params, batch_stats)
    before = {name: copy.deepcopy(models[name].state_dict()) for name in MODEL_NAMES}
    trainer = ttrain.Trainer(models, train_params, device="cpu",
                             optimizer_factory=optimizer_factory)
    out = trainer.step({k: _t(v) for k, v in (batch or default_batch).items()})
    after = {name: models[name].state_dict() for name in MODEL_NAMES}
    return before, after, out


def _sgd(params):
    return torch.optim.SGD(params, lr=1.0)


def _assert_updates_match(before, got, want):
    """Every tensor of the three state_dicts after one step: parameters to
    2e-4 of the tensor's largest update (SGD(1.0): its largest gradient),
    running statistics to 1e-5."""
    moved = {name: 0 for name in MODEL_NAMES}
    for name in MODEL_NAMES:
        assert set(got[name]) == set(want[name])
        for key, w in want[name].items():
            g = got[name][key]
            if key.endswith("num_batches_tracked"):
                assert int(g) == 1
                continue
            if "running_" in key:
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=f"{name}.{key}")
                assert not torch.equal(g, before[name][key])
                continue
            update = (w - before[name][key]).abs().max().item()
            tol = 2e-4 * max(1.0, update)
            err = (g - w).abs().max().item()
            assert err <= tol, f"{name}.{key}: {err} > {tol} (update {update})"
            moved[name] += update > 1e-3
    # the step really moved all three networks
    assert all(n > 3 for n in moved.values()), moved


_ROUTINGS = {
    "taichi": {},  # detach_kp_generator False, detach_kp_discriminator True
    "detach_kp_generator": {"detach_kp_generator": True},
    "kp_through_discriminator": {"detach_kp_discriminator": False},
}


@pytest.fixture(scope="module")
def sgd_steps(shared):
    """One SGD(1.0) step per gradient routing, in both packages."""
    cache = {}

    def run(name):
        if name not in cache:
            tp = dict(shared[0]["train_params"], **_ROUTINGS[name])
            cache[name] = (_jax_step(shared, tp, optax.sgd(1.0)), _port_step(shared, tp, _sgd))
        return cache[name]

    return run


@pytest.mark.parametrize("routing", sorted(_ROUTINGS))
def test_train_step_matches_jax(sgd_steps, routing):
    """One SGD(1.0) step from the same weights and batch: metrics, every
    updated parameter of the three networks and the batch-norm running
    statistics, for each way the configs route the keypoint gradients."""
    (want_after, want_out), (before, got_after, got_out) = sgd_steps(routing)
    np.testing.assert_allclose(got_out["metrics"].numpy(), np.asarray(want_out["metrics"]),
                               rtol=1e-4, atol=1e-5)
    for key in ("video_prediction", "video_deformed"):
        np.testing.assert_allclose(got_out[key].numpy(), np.asarray(want_out[key]), atol=1e-4)
    np.testing.assert_allclose(got_out["kp_joined"]["mean"].numpy(),
                               np.asarray(want_out["kp_joined"]["mean"]), atol=1e-5)
    assert not got_out["video_prediction"].requires_grad
    _assert_updates_match(before, got_after, want_after)


def test_routings_differ_where_they_should(sgd_steps):
    """The three routings share the forward, so they agree on the metrics and
    on the discriminator's update, and differ in the kp detector's."""
    key = "predictor.encoder.down_blocks.0.conv.weight"
    runs = {name: sgd_steps(name)[1] for name in _ROUTINGS}
    base = runs["taichi"]
    for name in ("detach_kp_generator", "kp_through_discriminator"):
        _, after, out = runs[name]
        torch.testing.assert_close(out["metrics"], base[2]["metrics"])
        torch.testing.assert_close(after["discriminator"]["conv.weight"],
                                   base[1]["discriminator"]["conv.weight"])
        assert (after["kp_detector"][key] - base[1]["kp_detector"][key]).abs().max() > 1e-3


def test_adam_step_matches_jax(shared, sgd_steps):
    """One step of the default optimizer, Adam(0.5, 0.999) at the scheduled
    rate, against `make_optimizer` applied to the JAX step's own gradients
    (the SGD(1.0) step above moved every parameter by exactly its gradient).
    Adam's first step is lr * g / (|g| + eps): where the gradient is well
    above f32 noise both packages move by the same amount to 1e-6; elsewhere
    noise can flip the sign, so the gap is only bounded by 2 * lr."""
    tp = shared[0]["train_params"]
    lr = tp["lr"]
    optimizer = jtrain.make_optimizer(jtrain.multistep_lr(lr, tp["epoch_milestones"], 10))
    before, got_after, _ = _port_step(shared, tp, None)
    (sgd_after, _), _ = sgd_steps("taichi")

    @jax.jit
    def jax_adam(params, grads):
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        return optax.apply_updates(params, updates)

    checked = 0
    for name in MODEL_NAMES:
        trained = [k for k in before[name]
                   if "running_" not in k and not k.endswith("num_batches_tracked")]
        grads = {k: before[name][k] - sgd_after[name][k] for k in trained}
        want_after = jax_adam({k: jnp.asarray(before[name][k].numpy()) for k in trained},
                              {k: jnp.asarray(grads[k].numpy()) for k in trained})
        for key in trained:
            grad, w = grads[key], _t(want_after[key])
            firm = grad.abs() > 1e-3
            gap = (got_after[name][key] - w).abs()
            assert gap.max() <= 2 * lr + 1e-7, f"{name}.{key}"
            if firm.any():
                assert gap[firm].max() <= 1e-6, f"{name}.{key}"
                step = (got_after[name][key] - before[name][key])[firm]
                torch.testing.assert_close(step, -lr * torch.sign(grad[firm]),
                                           atol=1e-6, rtol=0)
                checked += int(firm.sum())
    assert checked > 1000


def test_bf16_step_is_finite_and_close_to_f32(shared, sgd_steps):
    """compute_dtype bfloat16: f32 master weights, bf16 networks, f32
    keypoints and statistics. bf16 keeps 8 mantissa bits, so losses stay
    within a few percent of the f32 step's and the frames within a few bf16
    ulps of 1 on average."""
    tp = dict(shared[0]["train_params"], compute_dtype="bfloat16")
    before, after, out = _port_step(shared, tp, _sgd)
    _, (_, ref_after, ref_out) = sgd_steps("taichi")
    assert out["metrics"].dtype == torch.float32 and torch.isfinite(out["metrics"]).all()
    assert out["video_prediction"].dtype == torch.bfloat16
    assert out["kp_joined"]["mean"].dtype == torch.float32
    np.testing.assert_allclose(out["metrics"].numpy(), ref_out["metrics"].numpy(), rtol=0.05)
    gap = (out["video_prediction"].float() - ref_out["video_prediction"]).abs().mean()
    assert gap < 1e-2
    for name in MODEL_NAMES:
        for key, value in after[name].items():
            assert value.dtype == before[name][key].dtype  # masters stay f32
            assert torch.isfinite(value.float()).all(), f"{name}.{key}"
    key = "appearance_encoder.down_blocks.0.conv.weight"
    bf_update = after["generator"][key] - before["generator"][key]
    f32_update = ref_after["generator"][key] - before["generator"][key]
    assert bf_update.abs().max() > 0
    cosine = torch.nn.functional.cosine_similarity(bf_update.flatten(), f32_update.flatten(), dim=0)
    assert cosine > 0.9


def test_uint8_batch_matches_float_batch(shared):
    """A uint8 batch is rescaled on the device and gives the float batch's
    step."""
    tp = shared[0]["train_params"]
    rng = np.random.RandomState(3)
    u8 = {k: rng.randint(0, 256, (4, 1, HW, HW, 3), dtype=np.uint8) for k in ("source", "video")}
    f32 = {k: v.astype(np.float32) / 255.0 for k, v in u8.items()}
    _, after_u8, out_u8 = _port_step(shared, tp, _sgd, u8)
    _, after_f, out_f = _port_step(shared, tp, _sgd, f32)
    torch.testing.assert_close(out_u8["metrics"], out_f["metrics"], rtol=1e-6, atol=1e-6)
    for name in MODEL_NAMES:
        for key, value in after_f[name].items():
            torch.testing.assert_close(after_u8[name][key], value, rtol=0, atol=2e-5)


def test_trainer_and_train_models_refuse_missing_cuda(shared, monkeypatch):
    """The default device is CUDA; without a card the train entry points
    raise instead of running on the CPU."""
    config = shared[0]
    models = build_train_models(config, device="cpu")
    assert all(m.training for m in models.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_models(config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.Trainer(models, config["train_params"])
