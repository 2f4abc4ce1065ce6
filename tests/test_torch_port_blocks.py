"""The PyTorch port's building blocks and sub-modules held against the JAX
package on the CPU: each JAX block is initialised, given random batch-norm
running statistics, and copied into its port counterpart through
`from_jax_variables`; both then run the same numpy input.

Tolerances: f32 on both sides with other summation orders, so values agree
to f32 ulps per layer; 1e-5 absolute and relative on these shallow blocks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from monkeynet_tpu.models import blocks as jblocks
from monkeynet_tpu.models.dense_motion import DenseMotion as JDenseMotion
from monkeynet_tpu.models.movement_embedding import MovementEmbedding as JEmbedding
from monkeynet_tpu_torch.models import blocks as tblocks
from monkeynet_tpu_torch.models.dense_motion import DenseMotion as TDenseMotion
from monkeynet_tpu_torch.models.movement_embedding import MovementEmbedding as TEmbedding
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import _randomize_batch_stats, kp_to_torch, random_kp, tiny_config


def _jax_block_pair(jmodule, tmodule, x, seed=0):
    """Init a JAX block, randomise its running statistics, copy it into the
    port block; return both outputs on x (eval mode) as numpy."""
    variables = jax.jit(jmodule.init, static_argnums=2)(
        jax.random.PRNGKey(seed), jnp.asarray(x), False
    )
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _randomize_batch_stats(
        jax.tree.map(np.asarray, variables.get("batch_stats", {})), np.random.RandomState(seed)
    )
    tmodule.load_state_dict(from_jax_variables(params, stats))
    tmodule.eval()
    want = jax.jit(jmodule.apply, static_argnums=2)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False
    )
    with torch.no_grad():
        got = tmodule(torch.from_numpy(x))
    return got, want, params, stats


def _video(C, seed=1, B=2, D=2, h=8, w=8):
    return np.random.RandomState(seed).randn(B, D, h, w, C).astype(np.float32)


_BLOCKS = {
    "down": (lambda: jblocks.DownBlock(8), lambda: tblocks.DownBlock(3, 8), 3),
    "up": (lambda: jblocks.UpBlock(6), lambda: tblocks.UpBlock(5, 6), 5),
    "same_grouped": (
        lambda: jblocks.SameBlock(12, groups=3, kernel_size=(1, 1, 1), padding=(0, 0, 0)),
        lambda: tblocks.SameBlock(12, 12, groups=3, kernel_size=(1, 1, 1), padding=(0, 0, 0)),
        12,
    ),
    "res": (lambda: jblocks.ResBlock(7), lambda: tblocks.ResBlock(7), 7),
    "hourglass": (
        lambda: jblocks.Hourglass(4, out_features=5, num_blocks=3, max_features=16),
        lambda: tblocks.Hourglass(4, 3, 5, num_blocks=3, max_features=16),
        3,
    ),
}


@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_block_matches_jax_eval(name):
    jfn, tfn, cin = _BLOCKS[name]
    got, want, _, _ = _jax_block_pair(jfn(), tfn(), _video(cin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_encoder_matches_jax():
    x = _video(3)
    got, want, _, _ = _jax_block_pair(
        jblocks.Encoder(4, num_blocks=3, max_features=16), tblocks.Encoder(4, 3, 3, 16), x
    )
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_batchnorm_train_statistics_match_jax():
    """Train mode: batch statistics to normalise, running statistics updated
    with the unbiased variance and torch momentum."""
    x = _video(6, seed=2) * 3.0 + 1.0
    jbn = jblocks.SyncBatchNorm(6)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    stats = _randomize_batch_stats(
        jax.tree.map(np.asarray, variables["batch_stats"]), np.random.RandomState(3)
    )
    want, new_vars = jbn.apply(
        {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x), True,
        mutable=["batch_stats"],
    )
    tbn = tblocks.SyncBatchNorm(6)
    tbn.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables["params"]), stats))
    tbn.train()
    with torch.no_grad():
        got = tbn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for key, jkey in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(tbn, key).numpy(), np.asarray(new_vars["batch_stats"][jkey]),
            rtol=1e-5, atol=1e-6,
        )


@pytest.mark.parametrize("params", [
    dict(use_heatmap=True, use_deformed_source_image=True, heatmap_type="difference",
         norm_const=10, add_bg_feature_map=True),
    dict(use_heatmap=True, use_difference=True, heatmap_type="gaussian", norm_const="sum"),
    dict(use_heatmap=True, heatmap_type="difference", norm_const=100, scale_factor=0.5),
])
def test_movement_embedding_matches_jax(params):
    rng = np.random.RandomState(4)
    source = rng.rand(2, 1, 16, 12, 3).astype(np.float32)
    kp_d, kp_s = random_kp(rng, 2, 3, 4), random_kp(rng, 2, 1, 4)
    common = dict(num_kp=4, kp_variance="matrix", num_channels=3)
    want = JEmbedding(**common, **params).apply({}, jnp.asarray(source), kp_d, kp_s, train=False)
    temb = TEmbedding(**common, **params)
    got = temb(torch.from_numpy(source), kp_to_torch(kp_d), kp_to_torch(kp_s))
    assert got.shape[-1] == temb.out_channels
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_dense_motion_matches_jax():
    config = tiny_config()
    dm_params = config["model_params"]["generator_params"]["dense_motion_params"]
    common = dict(num_kp=4, num_channels=3, kp_variance="matrix")
    rng = np.random.RandomState(5)
    source = rng.rand(1, 1, 16, 16, 3).astype(np.float32)
    kp_d, kp_s = random_kp(rng, 1, 3, 4), random_kp(rng, 1, 1, 4)
    jdm = JDenseMotion(**common, **dm_params)
    variables = jax.jit(jdm.init, static_argnums=4)(
        jax.random.PRNGKey(0), jnp.asarray(source), kp_d, kp_s, False
    )
    params = jax.tree.map(np.asarray, variables["params"])
    head = params["hourglass"]["decoder"]["final_conv"]["conv"]
    head["kernel"] = (rng.randn(*head["kernel"].shape) * 0.05).astype(np.float32)
    stats = _randomize_batch_stats(jax.tree.map(np.asarray, variables["batch_stats"]), rng)
    want = jax.jit(jdm.apply, static_argnums=4)(
        {"params": params, "batch_stats": stats}, jnp.asarray(source), kp_d, kp_s, False
    )
    tdm = TDenseMotion(**common, **dm_params)
    tdm.load_state_dict(from_jax_variables(params, stats))
    tdm.eval()
    with torch.no_grad():
        got = tdm(torch.from_numpy(source), kp_to_torch(kp_d), kp_to_torch(kp_s))
    identity = np.asarray(jax_grid(16, 16))
    assert np.abs(np.asarray(want) - identity).max() > 0.05  # not the identity
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def jax_grid(h, w):
    from monkeynet_tpu.ops.grid import make_coordinate_grid

    return make_coordinate_grid((h, w))


def test_dense_motion_head_starts_at_identity():
    """Freshly built, the head is zero with the bg_init bias: the combine
    puts all mass on the background slot, so the grid is the identity."""
    from monkeynet_tpu_torch.models.blocks import init_parameters
    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    config = tiny_config()
    dm_params = config["model_params"]["generator_params"]["dense_motion_params"]
    tdm = init_parameters(TDenseMotion(num_kp=4, num_channels=3, kp_variance="matrix",
                                       **dm_params), torch.Generator().manual_seed(0)).eval()
    head = tdm.hourglass.decoder.conv
    assert torch.count_nonzero(head.weight) == 0
    assert head.bias.tolist() == [2.0, 0, 0, 0, 0, 0, 0]
    rng = np.random.RandomState(6)
    kp = kp_to_torch(random_kp(rng, 1, 2, 4))
    kp_s = {k: v[:, :1] for k, v in kp.items()}
    with torch.no_grad():
        grid = tdm(torch.rand(1, 1, 16, 16, 3), kp, kp_s)
    # bg weight e^2 / (e^2 + 4): the flow is a convex mix near the identity
    assert grid.shape == (1, 2, 16, 16, 2)
    np.testing.assert_array_less(
        (grid - make_coordinate_grid((16, 16))).abs().max().item(),
        (kp["mean"] - kp_s["mean"]).abs().max().item() + 1e-6,
    )
