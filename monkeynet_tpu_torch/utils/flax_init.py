"""The JAX package's flax initialisation of an `Encoder`, drawn in numpy.

The JAX package's frozen AED embedder (monkeynet_tpu/tasks/metrics.py) is
its `Encoder` at `encoder.init(jax.random.PRNGKey(0), zeros, False)`: never
trained, so its weights are whatever flax 0.12 draws there under JAX 0.9's
default PRNG. Every step of that draw is integer or uniform arithmetic, so
numpy repeats it bit for bit, and the port needs neither JAX nor flax:

- **threefry2x32**, 20 rounds (`jax._src.prng._threefry2x32_lowering`);
  `prng_key(seed)` is the key [seed >> 32, seed & 0xffffffff];
  `fold_in(key, d)` hashes the count pair [0, d]; with
  `jax_threefry_partitionable` (JAX 0.9's default, the one mode mirrored
  here) `split(key, n)` hashes the 64-bit counters 0 .. n - 1 as (high,
  low) word pairs, and `random_bits` XORs the two words of each counter's
  hash, counters in row-major order over the shape;
- **uniform** f32 on [minval, maxval): the top 23 bits of each word as the
  mantissa of a float in [1, 2), minus 1, times (maxval - minval) plus
  minval in one fused multiply-add, clamped below at minval
  (`jax.random.uniform` as XLA compiles it for the CPU);
- **flax's key of a parameter**: the SHA-1 of its module's scope path and
  the scope's `make_rng` count (1, 2, ... in the order the module declares
  its parameters), the first 4 bytes of the digest folded into the root key
  (`_fold_in_static` in flax/core/scope.py);
- the initialisers of monkeynet_tpu/models/blocks.py: conv kernels
  `variance_scaling(1/3, "fan_in", "uniform")`, i.e. U(-1, 1) times
  sqrt(3 * f32(1/3 / fan_in)), conv biases U(+-1/sqrt(fan_in)), batch norms
  at scale 1 and bias 0 with running mean 0 and variance 1.

`encoder_variables` returns the flax tree ({'params', 'batch_stats'} of
numpy arrays, flax's names: down{i}/conv/conv/kernel, down{i}/norm/scale,
...); utils/weights.py `from_jax_variables` maps it to the port's `Encoder`
state_dict. tests/test_torch_port_flax_init.py holds every step against
jax.random and flax.

`init_models_variables` draws the whole of the JAX package's `init_models`
(monkeynet_tpu/tasks/build.py) the same way: `split(PRNGKey(seed), 3)` into
the generator's, the discriminator's and the kp detector's root keys, then
each network's parameters at their scope paths, the dense-motion head's zero
kernel and its own bias (`bg_init` on the background logit), the norms'
ones and zeros and the batch statistics at 0 and 1. The trees map into the
port's networks through `from_jax_variables`, so the port runs the weights
the JAX package's `bench.py` timed. tests/test_torch_port_bench.py holds
them against `init_models` leaf for leaf.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) (uint32 arrays of one
    shape) under `key` (2 uint32): 20 rounds, a key injection every four."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ _PARITY)
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**63."""
    if not 0 <= seed < 2**63:
        raise ValueError(f"prng_key: seed {seed} outside [0, 2**63)")
    return np.array([seed >> 32, seed & _MASK], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) for a uint32 `data`."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & _MASK], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _counters(n: int):
    """The 64-bit counters 0 .. n - 1 as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(_MASK)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    y0, y1 = threefry2x32(key, *_counters(num))
    return np.stack([y0, y1], axis=-1)


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """32 random bits an element, as jax.random.bits(key, shape, uint32)."""
    y0, y1 = threefry2x32(key, *_counters(math.prod(shape)))
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(key, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval).

    XLA's CPU backend contracts `floats * (maxval - minval) + minval` into
    one fused multiply-add, so it is rounded once here: the product of a
    23-bit and a 24-bit mantissa and its sum with minval are exact in f64."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    fused = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fused.astype(np.float32))


def fold_in_static(key, data: Sequence) -> np.ndarray:
    """flax's `_fold_in_static`: the SHA-1 of the strings (UTF-8) and ints
    (big-endian, no leading zero bytes) of `data`, its first 4 bytes folded
    into `key` as one uint32."""
    if not data:
        return np.asarray(key, np.uint32)
    digest = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            digest.update(x.encode("utf-8"))
        elif isinstance(x, int):
            digest.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"fold_in_static: an int or a str, got {x!r}")
    return fold_in(key, int.from_bytes(digest.digest()[:4], byteorder="big"))


def param_key(root, path: Sequence[str], count: int) -> np.ndarray:
    """The key flax hands the `count`-th parameter (from 1) of the module at
    scope `path` under the 'params' key `root`."""
    return fold_in_static(root, tuple(path) + (count,))


def conv_kernel(key, shape) -> np.ndarray:
    """variance_scaling(1/3, 'fan_in', 'uniform') of a (kh, kw, in, out)
    kernel."""
    fan_in = shape[-2] * (math.prod(shape) / shape[-2] / shape[-1])
    variance = np.float32(1.0 / 3.0 / fan_in)
    return uniform(key, shape, -1.0) * np.sqrt(np.float32(3) * variance)


def conv_bias(key, features: int, fan_in: int) -> np.ndarray:
    """U(+-1/sqrt(fan_in)) of a conv's bias."""
    bound = 1.0 / math.sqrt(fan_in)
    return uniform(key, (features,), -bound, bound)


def hourglass_channels(block_expansion: int, num_blocks: int, max_features: int):
    return [min(max_features, block_expansion * 2 ** (i + 1)) for i in range(num_blocks)]


class _Draw:
    """The parameters and batch statistics of one network under its root
    key, collected at their flax scope paths as the modules declare them."""

    def __init__(self, root):
        self.root = root
        self.params: Dict = {}
        self.stats: Dict = {}

    @staticmethod
    def _put(tree, path, leaves):
        for p in path:
            tree = tree.setdefault(p, {})
        tree.update(leaves)

    def conv(self, path: Tuple[str, ...], kh: int, kw: int, cin: int, cout: int,
             groups: int = 1, zero_kernel: bool = False, bias=None) -> None:
        """A Conv3D named path[-1] (its inner conv named 'conv'): a
        (kh, kw, cin / groups, cout) kernel and a bias, at fan-in
        kh * kw * cin / groups. `zero_kernel` and `bias` replace the draws
        (the dense-motion head's zeros and bias values); flax takes the keys
        all the same, one for every initialiser."""
        scope = tuple(path) + ("conv",)
        ci = cin // groups
        self._put(self.params, scope, {
            "kernel": np.zeros((kh, kw, ci, cout), np.float32) if zero_kernel
            else conv_kernel(param_key(self.root, scope, 1), (kh, kw, ci, cout)),
            "bias": conv_bias(param_key(self.root, scope, 2), cout, kh * kw * ci)
            if bias is None else np.asarray(bias, np.float32),
        })

    def norm(self, path: Tuple[str, ...], features: int, stats: bool = True) -> None:
        """A batch norm (scale 1, bias 0, running mean 0 and variance 1), or
        with `stats` False an instance norm."""
        self._put(self.params, path, {"scale": np.ones(features, np.float32),
                                      "bias": np.zeros(features, np.float32)})
        if stats:
            self._put(self.stats, path, {"mean": np.zeros(features, np.float32),
                                         "var": np.ones(features, np.float32)})

    def encoder(self, path, block_expansion, cin, num_blocks, max_features) -> List[int]:
        """Encoder's DownBlocks; returns the skips' channels [cin, c1, ...]."""
        chans = [cin]
        for i, cout in enumerate(hourglass_channels(block_expansion, num_blocks, max_features)):
            self.conv(path + (f"down{i}", "conv"), 3, 3, chans[-1], cout)
            self.norm(path + (f"down{i}", "norm"), cout)
            chans.append(cout)
        return chans

    def decoder(self, path, block_expansion, skips: Sequence[int], num_blocks, max_features,
                out_features=None, zero_final=False, final_bias=None) -> int:
        """Decoder's UpBlocks over skips of `skips` channels, and its final
        conv unless `out_features` is None; returns the last concat's
        channels."""
        skips = list(skips)
        cin = skips.pop()
        for j, i in enumerate(range(num_blocks - 1, -1, -1)):
            cout = min(max_features, block_expansion * 2**i)
            self.conv(path + (f"up{j}", "conv"), 3, 3, cin, cout)
            self.norm(path + (f"up{j}", "norm"), cout)
            cin = cout + skips.pop()
        if out_features is not None:
            self.conv(path + ("final_conv",), 3, 3, cin, out_features,
                      zero_kernel=zero_final, bias=final_bias)
        return cin

    def hourglass(self, path, block_expansion, cin, cout, num_blocks, max_features,
                  zero_final=False, final_bias=None) -> None:
        skips = self.encoder(path + ("encoder",), block_expansion, cin, num_blocks, max_features)
        self.decoder(path + ("decoder",), block_expansion, skips, num_blocks, max_features,
                     cout, zero_final, final_bias)


def _embedding_channels(num_kp: int, num_channels: int, add_bg_feature_map: bool = False,
                        use_heatmap: bool = True, use_difference: bool = False,
                        use_deformed_source_image: bool = False, **_) -> int:
    """MovementEmbedding.out_channels."""
    per_kp = (int(use_heatmap) + 2 * int(use_difference)
              + num_channels * int(use_deformed_source_image))
    return per_kp * (num_kp + int(add_bg_feature_map))


def kp_detector_variables(config, root) -> Tuple[Dict, Dict]:
    """KPDetector: its hourglass 'predictor' from the image channels to
    num_kp heatmaps."""
    common, kp = config["model_params"]["common_params"], config["model_params"]["kp_detector_params"]
    draw = _Draw(root)
    draw.hourglass(("predictor",), kp["block_expansion"], common["num_channels"],
                   common["num_kp"], kp["num_blocks"], kp["max_features"])
    return draw.params, draw.stats


def generator_variables(config, root) -> Tuple[Dict, Dict]:
    """MotionTransferGenerator: the appearance encoder, dense motion (the
    mask embedding's grouped 1x1 blocks and its hourglass, whose final conv
    is zero with bias [bg_init, 0, ...] on the mask logits and zeros on the
    correction), the video decoder over skips widened by the kp embedding,
    the refinement ResBlocks and the 1x1 final conv."""
    common, gp = config["model_params"]["common_params"], config["model_params"]["generator_params"]
    K, C = common["num_kp"], common["num_channels"]
    draw = _Draw(root)
    skips = draw.encoder(("appearance_encoder",), gp["block_expansion"], C, gp["num_blocks"],
                         gp["max_features"])
    dm = gp.get("dense_motion_params")
    if dm is not None:
        emb = _embedding_channels(K, C, add_bg_feature_map=True, **dm["mask_embedding_params"])
        for i in range(dm.get("num_group_blocks", 0)):
            path = ("dense_motion", f"group_block{i}")
            draw.conv(path + ("conv",), 1, 1, emb, emb, groups=K + 1)
            draw.norm(path + ("norm",), emb)
        use_mask, use_corr = dm["use_mask"], dm["use_correction"]
        out = (K + 1) * int(use_mask) + 2 * int(use_corr)
        bias = ([dm.get("bg_init", 2.0)] + [0.0] * K) * int(use_mask) + [0.0, 0.0] * int(use_corr)
        draw.hourglass(("dense_motion", "hourglass"), dm["block_expansion"], emb, out,
                       dm["num_blocks"], dm["max_features"], zero_final=True, final_bias=bias)
    ke = gp.get("kp_embedding_params")
    extra = _embedding_channels(K, C, **ke) if ke is not None else 0
    features = draw.decoder(("video_decoder",), gp["block_expansion"],
                            [s + extra for s in skips], gp["num_blocks"], gp["max_features"])
    for i in range(gp["num_refinement_blocks"]):
        path = (f"refine{i}",)
        draw.norm(path + ("norm1",), features)
        draw.conv(path + ("conv1",), 3, 3, features, features)
        draw.norm(path + ("norm2",), features)
        draw.conv(path + ("conv2",), 3, 3, features, features)
    draw.conv(("final_conv",), 1, 1, features, C)
    return draw.params, draw.stats


def discriminator_variables(config, root) -> Dict:
    """Discriminator: VALID 4x4 down blocks (an instance norm on all but the
    first) over the frames and their kp heatmaps, and the 1x1 score conv.
    Its defaults are the JAX module's."""
    common = config["model_params"]["common_params"]
    dp = config["model_params"]["discriminator_params"]
    be, nb = dp.get("block_expansion", 64), dp.get("num_blocks", 4)
    max_features = dp.get("max_features", 512)
    ke = dp.get("kp_embedding_params")
    cin = common["num_channels"] + (
        _embedding_channels(common["num_kp"], common["num_channels"], **ke) if ke is not None
        else 0)
    draw = _Draw(root)
    for i in range(nb):
        cout = min(max_features, be * 2 ** (i + 1))
        draw.conv((f"down{i}", "conv"), 4, 4, cin, cout)
        if i != 0:
            draw.norm((f"down{i}", "norm"), cout, stats=False)
        cin = cout
    draw.conv(("score_conv",), 1, 1, cin, 1)
    return draw.params


def init_models_variables(config, image_shape, seed: int = 0) -> Tuple[Dict, Dict]:
    """The JAX package's `init_models(config, PRNGKey(seed), image_shape)`
    without JAX: (params, batch_stats), dicts keyed 'generator' /
    'discriminator' / 'kp_detector' (batch_stats without the discriminator,
    which has no batch norm) of flax trees of numpy f32 arrays. The
    parameters do not depend on the frame size; `image_shape` (H, W, C)
    must carry the config's channels."""
    if image_shape[-1] != config["model_params"]["common_params"]["num_channels"]:
        raise ValueError(f"image_shape {tuple(image_shape)}: the config has "
                         f"{config['model_params']['common_params']['num_channels']} channels")
    rng_g, rng_d, rng_k = split(prng_key(seed), 3)
    gen_params, gen_stats = generator_variables(config, rng_g)
    kp_params, kp_stats = kp_detector_variables(config, rng_k)
    params = {"generator": gen_params, "discriminator": discriminator_variables(config, rng_d),
              "kp_detector": kp_params}
    return params, {"generator": gen_stats, "kp_detector": kp_stats}


def encoder_variables(block_expansion: int, in_features: int, num_blocks: int,
                      max_features: int, seed: int = 0) -> Dict[str, Dict]:
    """The JAX package's `Encoder(block_expansion, num_blocks, max_features)`
    as `init(PRNGKey(seed), zeros((1, 1, H, W, in_features)), False)` draws
    it: {'params': ..., 'batch_stats': ...}, flax's names, numpy f32."""
    draw = _Draw(prng_key(seed))
    draw.encoder((), block_expansion, in_features, num_blocks, max_features)
    return {"params": draw.params, "batch_stats": draw.stats}
