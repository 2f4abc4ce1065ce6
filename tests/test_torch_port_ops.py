"""The PyTorch port's ops, and the plain versions of its four kernels, held
against the JAX package on the CPU.

Inputs come from numpy with fixed seeds and go through both packages. JAX's
Pallas kernels run as tests/test_pallas.py runs them here: the warp under
`pltpu.force_tpu_interpret_mode()`, the others with `interpret=True`.

Tolerances: both sides compute in f32 with the same formulas but other
fusion and summation orders, so values agree to a few f32 ulps of their
magnitude; 1e-5 absolute on O(1) values unless a comment says otherwise.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from monkeynet_tpu import ops as jops
from monkeynet_tpu.ops import gaussian as jgauss
from monkeynet_tpu.ops import sampling as jsamp
from monkeynet_tpu_torch.ops import gaussian as tgauss
from monkeynet_tpu_torch.ops import grid as tgrid
from monkeynet_tpu_torch.ops import sampling as tsamp
from monkeynet_tpu_torch.ops.cuda import combine as tcombine
from monkeynet_tpu_torch.ops.cuda import heatmap as theat
from monkeynet_tpu_torch.ops.cuda import softargmax as tsoft
from monkeynet_tpu_torch.ops.cuda import warp as twarp

from .torch_port_common import kp_to_torch, random_kp

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _warp_data(B=2, H=12, W=16, C=5, Ho=9, Wo=7, seed=0):
    """Grid in [-1.3, 1.3]: covers interior, border and outside samples."""
    rng = np.random.RandomState(seed)
    img = rng.randn(B, H, W, C).astype(np.float32)
    grid = (rng.rand(B, Ho, Wo, 2).astype(np.float32) * 2.6) - 1.3
    return img, grid


def _logits(seed, clip):
    """(2, 3, 16, 12, 4) heatmap logits. With a clip they are scaled so that
    the clip binds on some planes while every covariance stays well
    conditioned: the clip divides by the smallest singular value, and at
    1e-5 that amplifies f32 noise by 1e4, past any fixed tolerance."""
    logits = np.random.RandomState(seed).randn(2, 3, 16, 12, 4)
    return (logits * (0.3 if clip else 1.0)).astype(np.float32)


# ---- (a) ops ---------------------------------------------------------------

def test_grid_and_mat2_match_jax():
    np.testing.assert_allclose(
        tgrid.make_coordinate_grid((5, 7)).numpy(),
        np.asarray(jops.make_coordinate_grid((5, 7))), atol=0,
    )
    rng = np.random.RandomState(0)
    m = rng.randn(3, 4, 2, 2).astype(np.float32)
    m = m @ m.transpose(0, 1, 3, 2) + 0.1 * np.eye(2, dtype=np.float32)
    np.testing.assert_allclose(
        tgrid.mat2_inverse(_t(m)).numpy(), np.asarray(jops.mat2_inverse(m)),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        tgrid.mat2_smallest_singular(_t(m)).numpy(),
        np.asarray(jops.mat2_smallest_singular(m)), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("shape", [(2, 12, 16, 5, 9, 7), (1, 8, 8, 3, 8, 8)])
def test_grid_sample_matches_jax(shape):
    img, grid = _warp_data(*shape)
    np.testing.assert_allclose(
        tsamp.grid_sample(_t(img), _t(grid)).numpy(),
        np.asarray(jsamp.grid_sample(img, grid)), atol=ATOL,
    )


def test_grid_sample_edges_match_jax():
    """Samples in (-1, 0) pixels and past the last pixel keep their in-range
    corners with the right weights (zeros padding)."""
    img = np.arange(12, dtype=np.float32).reshape(1, 3, 4, 1)
    xs = np.array([-1.4, -1.2, -1.0, 0.0, 1.0, 1.2, 1.5], np.float32)
    grid = np.stack(np.meshgrid(xs, xs), axis=-1)[None].astype(np.float32)
    np.testing.assert_allclose(
        tsamp.grid_sample(_t(img), _t(grid)).numpy(),
        np.asarray(jsamp.grid_sample(img, grid)), atol=ATOL,
    )


def test_warp_video_matches_jax():
    rng = np.random.RandomState(1)
    src = rng.randn(2, 10, 12, 4).astype(np.float32)
    grid = (rng.rand(2, 3, 6, 5, 2).astype(np.float32) * 2.4) - 1.2
    np.testing.assert_allclose(
        tsamp.warp_video(_t(src), _t(grid)).numpy(),
        np.asarray(jsamp.warp_video(src, grid)), atol=ATOL,
    )


def test_shift_sample_matches_jax():
    rng = np.random.RandomState(2)
    img = rng.randn(2, 12, 10, 3).astype(np.float32)
    shifts = (rng.rand(2, 5, 2).astype(np.float32) - 0.5) * 1.5
    np.testing.assert_allclose(
        tsamp.shift_sample(_t(img), _t(shifts)).numpy(),
        np.asarray(jsamp.shift_sample(img, shifts)), atol=ATOL,
    )


@pytest.mark.parametrize("out_hw", [(64, 64), (16, 8), (24, 40), (12, 9)])
def test_resize_nearest_matches_jax(out_hw):
    x = np.random.RandomState(3).randn(2, 3, 32, 32, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tsamp.resize_nearest(_t(x), out_hw).numpy(),
        np.asarray(jsamp.resize_nearest(x, out_hw)),
    )


@pytest.mark.parametrize("mode,out_hw", [("trilinear", (8, 8)), ("trilinear", (32, 24)),
                                         ("nearest", (8, 8))])
def test_resize_video_matches_jax(mode, out_hw):
    x = np.random.RandomState(4).randn(1, 2, 16, 16, 3).astype(np.float32)
    np.testing.assert_allclose(
        tsamp.resize_video(_t(x), out_hw, mode).numpy(),
        np.asarray(jsamp.resize_video(x, out_hw, mode)), atol=ATOL,
    )


@pytest.mark.parametrize("variance", ["matrix", "single", 0.01])
def test_kp2gaussian_matches_jax(variance):
    kp = random_kp(np.random.RandomState(5), 2, 3, 4, variance)
    np.testing.assert_allclose(
        tgauss.kp2gaussian(kp_to_torch(kp), (16, 12), variance).numpy(),
        np.asarray(jgauss.kp2gaussian(kp, (16, 12), variance)), atol=ATOL,
    )


@pytest.mark.parametrize("variance,clip", [("matrix", None), ("matrix", 0.05),
                                           ("single", None), (0.01, None)])
def test_spatial_softmax_and_gaussian2kp_match_jax(variance, clip):
    logits = _logits(6, clip)
    heat_t = tgauss.spatial_softmax(_t(logits), 0.1)
    heat_j = jgauss.spatial_softmax(logits, 0.1)
    # softmax values lie in (0, 1]: f32 ulps of 1
    np.testing.assert_allclose(heat_t.numpy(), np.asarray(heat_j), atol=1e-6)
    kp_t = tgauss.gaussian2kp(heat_t, variance, clip)
    kp_j = jgauss.gaussian2kp(heat_j, variance, clip)
    assert set(kp_t) == set(kp_j)
    np.testing.assert_allclose(kp_t["mean"].numpy(), np.asarray(kp_j["mean"]), atol=ATOL)
    if "var" in kp_j:
        np.testing.assert_allclose(
            kp_t["var"].numpy(), np.asarray(kp_j["var"]), atol=1e-4, rtol=1e-4
        )


# ---- (b) the plain versions of the four kernels ----------------------------

@pytest.mark.parametrize("shape", [(2, 12, 16, 5, 9, 7), (1, 48, 48, 3, 8, 8)])
def test_warp_plain_matches_jnp_and_pallas(shape):
    from monkeynet_tpu.ops.pallas.warp import grid_sample_pallas

    img, grid = _warp_data(*shape, seed=7)
    before = twarp.warp.launches
    out = twarp.warp(_t(img), _t(grid)).numpy()  # CPU tensor: the plain version
    assert twarp.warp.launches == before
    np.testing.assert_allclose(out, np.asarray(jsamp.grid_sample(img, grid)), atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(grid_sample_pallas(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_allclose(out, pallas, atol=ATOL)


def test_combine_plain_matches_jnp_and_pallas():
    from monkeynet_tpu.ops.pallas.combine import (
        dense_motion_combine_pallas,
        dense_motion_combine_reference,
    )

    rng = np.random.RandomState(8)
    B, D, Hh, Ww, K1 = 2, 3, 12, 16, 5
    logits = rng.randn(B, D, Hh, Ww, K1).astype(np.float32)
    diff = (rng.randn(B, D, K1, 2) * 0.3).astype(np.float32)
    corr = (rng.randn(B, D, Hh, Ww, 2) * 0.1).astype(np.float32)
    before = tcombine.combine.launches
    out = tcombine.combine(_t(logits), _t(diff), _t(corr)).numpy()
    assert tcombine.combine.launches == before
    np.testing.assert_allclose(
        out, np.asarray(dense_motion_combine_reference(logits, diff, corr)), atol=ATOL
    )
    pallas = dense_motion_combine_pallas(
        jnp.asarray(logits), jnp.asarray(diff), jnp.asarray(corr), True
    )
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL)


@pytest.mark.parametrize("variance,clip", [("matrix", None), ("matrix", 0.05),
                                           ("single", None), (0.01, None)])
def test_softargmax_plain_matches_jnp_and_pallas(variance, clip):
    from monkeynet_tpu.ops.pallas.softargmax import gaussian2kp_pallas

    logits = _logits(9, clip)
    before = tsoft.softargmax_stats.launches
    kp = tsoft.softargmax(_t(logits), 0.1, variance, clip)
    assert tsoft.softargmax_stats.launches == before
    ref = jgauss.gaussian2kp(jgauss.spatial_softmax(logits, 0.1), variance, clip)
    pallas = gaussian2kp_pallas(jnp.asarray(logits), 0.1, variance, clip, interpret=True)
    assert set(kp) == set(ref) == set(pallas)
    for want in (ref, pallas):
        np.testing.assert_allclose(kp["mean"].numpy(), np.asarray(want["mean"]), atol=ATOL)
        if "var" in want:
            np.testing.assert_allclose(
                kp["var"].numpy(), np.asarray(want["var"]), atol=1e-4, rtol=1e-4
            )
    assert kp["mean"].dtype == torch.float32


@pytest.mark.parametrize("variance", ["matrix", "single", 0.01])
@pytest.mark.parametrize("norm", [None, "sum", 10.0])
def test_heatmap_plain_matches_jnp_and_pallas(variance, norm):
    """Symmetric covariances: the only case in which the Pallas kernel's
    packed determinant equals the jnp form."""
    from monkeynet_tpu.ops.pallas.heatmap import kp2gaussian_pallas

    kp = random_kp(np.random.RandomState(10), 2, 3, 4, variance)
    before = theat.heatmap.launches
    out = theat.heatmap(kp_to_torch(kp), (16, 12), variance, norm).numpy()
    assert theat.heatmap.launches == before
    ref = np.asarray(jgauss.kp2gaussian(kp, (16, 12), variance))
    if norm == "sum":
        ref = ref / ref.sum(axis=(-1, -2), keepdims=True)
    elif norm is not None:
        ref = ref / norm
    np.testing.assert_allclose(out, ref, atol=ATOL)
    pallas = kp2gaussian_pallas(
        {k: jnp.asarray(v) for k, v in kp.items()}, (16, 12), variance,
        norm_const=norm, interpret=True,
    )
    # the Pallas test of the same kernel (tests/test_pallas.py) holds it to
    # 2e-5 against the jnp form; the port inherits that bound
    np.testing.assert_allclose(out, np.asarray(pallas), atol=2e-5)


@pytest.mark.parametrize("fn", ["warp", "combine", "softargmax", "heatmap"])
def test_wrappers_refuse_other_devices(fn):
    """A wrapper takes the plain version only for CPU tensors; anything else
    must be a CUDA tensor for the kernel, or the call raises."""
    meta = {"device": "meta"}
    calls = {
        "warp": lambda: twarp.warp(torch.empty(1, 4, 4, 4, **meta),
                                   torch.empty(1, 2, 2, 2, **meta)),
        "combine": lambda: tcombine.combine(torch.empty(1, 1, 4, 4, 3, **meta),
                                            torch.empty(1, 1, 3, 2, **meta),
                                            torch.empty(1, 1, 4, 4, 2, **meta)),
        "softargmax": lambda: tsoft.softargmax(torch.empty(1, 1, 4, 4, 2, **meta), 0.1),
        "heatmap": lambda: theat.heatmap({"mean": torch.empty(1, 1, 2, 2, **meta)},
                                         (4, 4), 0.01, None),
    }
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        calls[fn]()
