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
  here) `random_bits` hashes the 64-bit counters 0 .. n - 1 as (high, low)
  word pairs and XORs the two words of each counter's hash, counters in
  row-major order over the shape;
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
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence, Tuple

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

    def conv(self, path: Tuple[str, ...], kh: int, kw: int, cin: int, cout: int) -> None:
        """A Conv3D named path[-1] (its inner conv named 'conv'): a
        (kh, kw, cin, cout) kernel and a bias, at fan-in kh * kw * cin."""
        scope = tuple(path) + ("conv",)
        self._put(self.params, scope, {
            "kernel": conv_kernel(param_key(self.root, scope, 1), (kh, kw, cin, cout)),
            "bias": conv_bias(param_key(self.root, scope, 2), cout, kh * kw * cin),
        })

    def norm(self, path: Tuple[str, ...], features: int) -> None:
        """A batch norm: scale 1, bias 0, running mean 0 and variance 1."""
        self._put(self.params, path, {"scale": np.ones(features, np.float32),
                                      "bias": np.zeros(features, np.float32)})
        self._put(self.stats, path, {"mean": np.zeros(features, np.float32),
                                     "var": np.ones(features, np.float32)})

    def encoder(self, path, block_expansion, cin, num_blocks, max_features) -> None:
        """Encoder's DownBlocks."""
        for i, cout in enumerate(hourglass_channels(block_expansion, num_blocks, max_features)):
            self.conv(path + (f"down{i}", "conv"), 3, 3, cin, cout)
            self.norm(path + (f"down{i}", "norm"), cout)
            cin = cout


def encoder_variables(block_expansion: int, in_features: int, num_blocks: int,
                      max_features: int, seed: int = 0) -> Dict[str, Dict]:
    """The JAX package's `Encoder(block_expansion, num_blocks, max_features)`
    as `init(PRNGKey(seed), zeros((1, 1, H, W, in_features)), False)` draws
    it: {'params': ..., 'batch_stats': ...}, flax's names, numpy f32."""
    draw = _Draw(prng_key(seed))
    draw.encoder((), block_expansion, in_features, num_blocks, max_features)
    return {"params": draw.params, "batch_stats": draw.stats}
