"""Gradients of the PyTorch port's ops held against the JAX package on the
CPU: the warp's gradients w.r.t. source and grid (the plain versions of the
d_src and d_grid kernels), the combine's closed-form backward, and
shift_sample's gradient w.r.t. the shifts.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX warp kernels run as tests/test_pallas.py runs them here, under
`pltpu.force_tpu_interpret_mode()`; the combine kernel with interpret=True.

Tolerances: both sides compute in f32 with the same formulas but other
summation orders. Gradients here are sums of up to a few hundred O(1)
terms, so they agree to ~1e-6 of their magnitude; 2e-5 absolute unless a
comment says otherwise.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from monkeynet_tpu.ops import sampling as jsamp
from monkeynet_tpu.ops.pallas.warp import grid_sample_pallas
from monkeynet_tpu_torch.ops import sampling as tsamp
from monkeynet_tpu_torch.ops.cuda import combine as tcombine
from monkeynet_tpu_torch.ops.cuda import heatmap as theat
from monkeynet_tpu_torch.ops.cuda import softargmax as tsoft
from monkeynet_tpu_torch.ops.cuda import warp as twarp
from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

from .torch_port_common import kp_to_torch, random_kp

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _away_from_integers(grid, H, W, margin=0.05):
    """Move every pixel coordinate at least `margin` away from an integer:
    there floor() is stable under f32 rounding, so both packages pick the
    same corner and the gradient is continuous."""
    out = grid.copy()
    for axis, n in ((0, W), (1, H)):
        px = (out[..., axis] + 1.0) * 0.5 * (n - 1)
        frac = px - np.floor(px)
        px = np.floor(px) + np.clip(frac, margin, 1.0 - margin)
        out[..., axis] = px / (0.5 * (n - 1)) - 1.0
    return out.astype(np.float32)


def _grid_case(kind, rng, B, H, W, Ho, Wo):
    if kind == "random":  # interior samples
        grid = rng.rand(B, Ho, Wo, 2).astype(np.float32) * 1.8 - 0.9
        return _away_from_integers(grid, H, W)
    if kind == "out_of_range":  # border and outside samples too
        grid = rng.rand(B, Ho, Wo, 2).astype(np.float32) * 2.8 - 1.4
        return _away_from_integers(grid, H, W)
    # exactly-integer pixel coordinates (H-1 and W-1 are powers of two, so
    # i / (n-1) * 2 - 1 and its way back are exact in f32), shifted by whole
    # pixels so some land outside
    ys = rng.randint(-1, H + 1, (B, Ho, Wo)).astype(np.float32)
    xs = rng.randint(-1, W + 1, (B, Ho, Wo)).astype(np.float32)
    return np.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1], axis=-1).astype(np.float32)


def _jax_warp_grads(sampler, img, grid, dout):
    def loss(i, g):
        return jnp.sum(sampler(i, g) * dout)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))


@pytest.mark.parametrize("kind", ["random", "out_of_range", "integer"])
def test_warp_gradients_match_jnp_and_pallas(kind):
    """d_src and d_grid of the plain path (autograd of grid_sample, and the
    wrappers, which take it on the CPU) against jax.grad of the jnp
    grid_sample and of the Pallas kernels in interpret mode."""
    rng = np.random.RandomState({"random": 0, "out_of_range": 1, "integer": 2}[kind])
    B, H, W, C, Ho, Wo = 2, 9, 17, 5, 8, 6
    img = rng.randn(B, H, W, C).astype(np.float32)
    grid = _grid_case(kind, rng, B, H, W, Ho, Wo)
    dout = rng.randn(B, Ho, Wo, C).astype(np.float32)
    if kind == "integer":
        px = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
        assert np.array_equal(px, np.round(px))

    ti, tg = _t(img).requires_grad_(), _t(grid).requires_grad_()
    before = (twarp.warp.launches, twarp.warp_dsrc.launches, twarp.warp_dgrid.launches)
    out = twarp.warp(ti, tg)  # CPU tensors: the plain version and its autograd
    d_img, d_grid = torch.autograd.grad(out, (ti, tg), _t(dout))
    assert (twarp.warp.launches, twarp.warp_dsrc.launches, twarp.warp_dgrid.launches) == before
    # the backward wrappers take the same plain versions on the CPU
    torch.testing.assert_close(twarp.warp_dsrc(_t(grid), _t(dout), img.shape), d_img)
    torch.testing.assert_close(twarp.warp_dgrid(_t(img), _t(grid), _t(dout)), d_grid)

    want_img, want_grid = _jax_warp_grads(jsamp.grid_sample, img, grid, dout)
    np.testing.assert_allclose(d_img.numpy(), np.asarray(want_img), atol=ATOL)
    np.testing.assert_allclose(d_grid.numpy(), np.asarray(want_grid), atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        pal_img, pal_grid = _jax_warp_grads(grid_sample_pallas, img, grid, dout)
    np.testing.assert_allclose(d_img.numpy(), np.asarray(pal_img), atol=ATOL)
    # d_grid is scaled by (W-1)/2 = 8 and sums 4 * C terms
    np.testing.assert_allclose(d_grid.numpy(), np.asarray(pal_grid), atol=1e-4)
    assert np.abs(np.asarray(want_grid)).max() > 0.1


def test_warp_dgrid_is_the_right_difference_at_integers():
    """At an integer coordinate the corner is the pixel itself, so d/dx is
    (W-1)/2 * (src[x+1] - src[x]), and zero past the last column, where the
    right neighbour lies outside."""
    H, W = 5, 9
    img = torch.arange(H * W, dtype=torch.float32).reshape(1, H, W, 1) ** 2
    grid = make_coordinate_grid((H, W))[None].contiguous()
    d_grid = twarp.warp_dgrid(img, grid, torch.ones(1, H, W, 1))
    plane = img[0, :, :, 0]
    want_dx = torch.zeros(H, W)
    want_dx[:, :-1] = (plane[:, 1:] - plane[:, :-1]) * 0.5 * (W - 1)
    want_dx[:, -1] = -plane[:, -1] * 0.5 * (W - 1)  # the neighbour outside reads as zero
    torch.testing.assert_close(d_grid[0, :, :, 0], want_dx)


def test_warp_gradients_in_bf16_stay_close_to_f32():
    """A bf16 source rounds the corner weights to bf16 in the plain version
    (the kernels keep them f32): the gradients stay within a few bf16 ulps
    (2^-8 each) of the f32 ones, relative to the largest value."""
    rng = np.random.RandomState(3)
    B, H, W, C = 2, 9, 17, 8
    img = _t(rng.randn(B, H, W, C).astype(np.float32))
    grid = _t(_grid_case("out_of_range", rng, B, H, W, 8, 6))
    dout = _t(rng.randn(B, 8, 6, C).astype(np.float32))
    ref_src = twarp.warp_dsrc(grid, dout, tuple(img.shape))
    ref_grid = twarp.warp_dgrid(img, grid, dout)
    got_src = twarp.warp_dsrc(grid, dout.bfloat16(), tuple(img.shape))
    got_grid = twarp.warp_dgrid(img.bfloat16(), grid, dout.bfloat16())
    assert got_src.dtype == torch.bfloat16 and got_grid.dtype == torch.float32
    assert (got_src.float() - ref_src).abs().max() <= 4 * 2.0**-8 * ref_src.abs().max()
    assert (got_grid - ref_grid).abs().max() <= 4 * 2.0**-8 * ref_grid.abs().max()


def _combine_data(seed=8):
    rng = np.random.RandomState(seed)
    B, D, Hh, Ww, K1 = 2, 3, 12, 16, 5
    logits = rng.randn(B, D, Hh, Ww, K1).astype(np.float32)
    diff = (rng.randn(B, D, K1, 2) * 0.3).astype(np.float32)
    corr = (rng.randn(B, D, Hh, Ww, 2) * 0.1).astype(np.float32)
    g = rng.randn(B, D, Hh, Ww, 2).astype(np.float32)
    return logits, diff, corr, g


def test_combine_backward_matches_pallas_vjp_and_autograd():
    """CombineFunction.backward, called directly on CPU tensors, against
    jax.grad of the Pallas combine (interpret mode) and against autograd of
    combine_plain; and the same through `combine` itself."""
    from monkeynet_tpu.ops.pallas.combine import dense_motion_combine_pallas

    logits, diff, corr, g = _combine_data()
    ctx = types.SimpleNamespace(saved_tensors=(_t(logits), _t(diff)))
    got = tcombine.CombineFunction.backward(ctx, _t(g))

    want = jax.grad(
        lambda l, d, c: jnp.sum(dense_motion_combine_pallas(l, d, c, True) * g),
        argnums=(0, 1, 2),
    )(jnp.asarray(logits), jnp.asarray(diff), jnp.asarray(corr))
    leaves = [_t(a).requires_grad_() for a in (logits, diff, corr)]
    plain = torch.autograd.grad(tcombine.combine_plain(*leaves), leaves, _t(g))
    through = torch.autograd.grad(tcombine.combine(*leaves), leaves, _t(g))
    for name, a, w, p, t in zip(("dlogits", "ddiff", "dcorr"), got, want, plain, through):
        # ddiff sums 192 pixels per entry
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), p.numpy(), atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), t.numpy(), atol=0, err_msg=name)


def test_shift_sample_gradient_matches_jax():
    """d/d shifts flows through the fractional part only (the floor carries
    no gradient in either package), d/d image through both matmuls."""
    rng = np.random.RandomState(2)
    img = rng.randn(2, 12, 10, 3).astype(np.float32)
    shifts = ((rng.rand(2, 5, 2).astype(np.float32) - 0.5) * 1.5)
    # keep the pixel offsets away from integers, where floor() could flip
    shifts = _away_from_integers(shifts[:, :, None, :] - 1.0, 12, 10)[:, :, 0, :] + 1.0
    dout = rng.randn(2, 5, 12, 10, 3).astype(np.float32)
    ti, ts = _t(img).requires_grad_(), _t(shifts).requires_grad_()
    got = torch.autograd.grad(tsamp.shift_sample(ti, ts), (ti, ts), _t(dout))
    want = jax.grad(
        lambda i, s: jnp.sum(jsamp.shift_sample(i, s) * dout), argnums=(0, 1)
    )(jnp.asarray(img), jnp.asarray(shifts))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
    # scaled by (n-1)/2 and summed over 360 values per shift
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-4, rtol=1e-5)
    assert np.abs(np.asarray(want[1])).max() > 1.0


@pytest.mark.parametrize("fn", ["softargmax", "heatmap"])
def test_forward_only_wrappers_refuse_tracked_inputs(fn):
    """The softargmax and heatmap kernels have no backward, so their
    wrappers raise on an input that requires grad, on any device, rather
    than return a result that cuts the graph; under no_grad they run."""
    if fn == "softargmax":
        x = torch.randn(1, 1, 4, 4, 2, requires_grad=True)
        call = lambda: tsoft.softargmax(x, 0.1)  # noqa: E731
    else:
        kp = kp_to_torch(random_kp(np.random.RandomState(0), 1, 1, 2))
        kp["mean"].requires_grad_()
        call = lambda: theat.heatmap(kp, (4, 4), "matrix", None)  # noqa: E731
    with pytest.raises(RuntimeError, match="forward-only"):
        call()
    with torch.no_grad():
        call()


@pytest.mark.parametrize("module", ["kp_detector", "movement_embedding"])
def test_modules_differentiate_in_training_mode_only(module):
    """Training mode takes the plain, differentiable path; eval mode takes
    the forward-only kernel wrapper, which refuses a tracked input."""
    if module == "kp_detector":
        from monkeynet_tpu_torch.models.kp_detector import KPDetector

        net = KPDetector(4, 2, 3, 16, 2, 0.1, "matrix")
        run = lambda: net(torch.rand(1, 2, 8, 8, 3))["mean"]  # noqa: E731
    else:
        from monkeynet_tpu_torch.models.movement_embedding import MovementEmbedding

        net = MovementEmbedding(2, "matrix", 3)
        kp = kp_to_torch(random_kp(np.random.RandomState(1), 1, 2, 2))
        kp["mean"].requires_grad_()
        run = lambda: net(torch.rand(1, 1, 8, 8, 3), kp, kp)  # noqa: E731
    net.train()
    assert run().grad_fn is not None
    net.eval()
    with pytest.raises(RuntimeError, match="forward-only"):
        run()
