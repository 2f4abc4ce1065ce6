"""The port's numpy draw of flax's init (monkeynet_tpu_torch/utils/flax_init.py)
against jax.random and flax themselves.

(a) The PRNG: `prng_key`, `fold_in`, `random_bits` and `uniform`
    against jax.random on a few keys, in the mode the installed JAX runs
    (threefry2x32 with `jax_threefry_partitionable`, JAX 0.9's default,
    asserted), and `fold_in_static` against flax's `_fold_in_static`.
(b) `encoder_variables` against the JAX package's `Encoder.init` at
    PRNGKey(0), as its frozen AED embedder draws it, at configs/shapes.yaml's
    widths: every leaf, and the port's state_dict through `from_jax_variables`,
    bit for bit.
(c) Both packages' `EmbeddingExtractor(embedder="frozen")`, each with no
    weights given, on one small video pair, and `aed` of the pair.
    Tolerance: 1e-5 relative on embeddings and AED (the same weights; cuDNN
    and XLA sum the convolutions in other orders).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import scope as flax_scope

from monkeynet_tpu.models.blocks import Encoder as JEncoder
from monkeynet_tpu.tasks import metrics as jmetrics
from monkeynet_tpu_torch.models.blocks import Encoder
from monkeynet_tpu_torch.tasks import metrics as tmetrics
from monkeynet_tpu_torch.utils import flax_init
from monkeynet_tpu_torch.utils.config import load_config
from monkeynet_tpu_torch.utils.weights import from_jax_variables

SEEDS = [0, 1, 42, 2**31 - 1]


def test_the_mirrored_prng_mode_is_the_installed_one():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_matches_jax_random(seed):
    key, mine = jax.random.PRNGKey(seed), flax_init.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key), mine)
    for data in (0, 1, 7, 123_456_789, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(key, data)),
                                      flax_init.fold_in(mine, data))
    np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (3, 7), jnp.uint32)),
                                  flax_init.random_bits(mine, (3, 7)))
    # bounds whose width rounds: the fused multiply-add decides the last bit
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-0.3, 0.7), (-1 / 3**0.5, 1 / 3**0.5),
                   (-1 / 27**0.5, 1 / 27**0.5)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(key, (5, 67), jnp.float32, lo, hi)),
            flax_init.uniform(mine, (5, 67), lo, hi))


@pytest.mark.parametrize("path", [("down0", "conv", "conv", 1), ("down3", "norm", 2), (5,),
                                  ("décor", 300)])
def test_fold_in_static_matches_flax(path):
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(np.asarray(flax_scope._fold_in_static(key, path)),
                                  flax_init.fold_in_static(flax_init.prng_key(3), path))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def shapes_embedder():
    """configs/shapes.yaml's embedder: the JAX package's init and the numpy draw."""
    config = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "shapes.yaml"))
    gp = config["model_params"]["generator_params"]
    H, W, C = config["dataset_params"].get("image_shape", (64, 64, 3))
    encoder = JEncoder(gp["block_expansion"], num_blocks=gp["num_blocks"],
                       max_features=gp["max_features"])
    dummy = jnp.zeros((1, 1, H, W, C), jnp.float32)
    want = jax.jit(lambda r: encoder.init(r, dummy, False))(jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(np.asarray, {k: dict(v) for k, v in want.items()})
    got = flax_init.encoder_variables(gp["block_expansion"], C, gp["num_blocks"],
                                      gp["max_features"])
    return config, want, got


def test_encoder_variables_match_the_jax_init_bit_for_bit(shapes_embedder):
    config, want, got = shapes_embedder
    for collection in ("params", "batch_stats"):
        w, g = dict(_leaves(want[collection])), dict(_leaves(got[collection]))
        assert set(w) == set(g)
        for path in w:
            assert g[path].dtype == w[path].dtype == np.float32
            np.testing.assert_array_equal(g[path], w[path], err_msg="/".join(path))
    sd_want = from_jax_variables(want["params"], want["batch_stats"])
    sd_got = from_jax_variables(got["params"], got["batch_stats"])
    gp = config["model_params"]["generator_params"]
    port = Encoder(gp["block_expansion"], 3, gp["num_blocks"], gp["max_features"])
    assert set(sd_got) == set(sd_want) == set(port.state_dict())
    for key in sd_want:
        assert torch.equal(sd_got[key], sd_want[key]), key
    # the kernels really are drawn: U(+-sqrt(3 * var)) fills its range
    for path, v in _leaves(got["params"]):
        if path[-1] == "kernel":
            bound = (3 * (1 / 3) / (9 * v.shape[2])) ** 0.5
            assert 0.9 * bound < np.abs(v).max() <= bound, path


def test_frozen_embedder_and_aed_match_the_jax_package(shapes_embedder):
    config = shapes_embedder[0]
    H, W, C = config["dataset_params"].get("image_shape", (64, 64, 3))
    rng = np.random.RandomState(21)
    gt = rng.rand(1, 3, H, W, C).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.randn(*gt.shape), 0, 1).astype(np.float32)
    jax_embed = jmetrics.EmbeddingExtractor(config, chunk=2)
    port_embed = tmetrics.EmbeddingExtractor(config, chunk=2, device="cpu")
    want = [jax_embed(v) for v in (gt, pred)]
    got = [port_embed(v) for v in (gt, pred)]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 3, config["model_params"]["generator_params"]
                                      ["max_features"])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    aed_got, aed_want = tmetrics.aed(*got), jmetrics.aed(*want)
    assert aed_got == pytest.approx(aed_want, rel=1e-5) and aed_want > 0
