"""Bilinear warp, align_corners=True with zeros padding: its three kernels
(forward, gradient w.r.t. the source, gradient w.r.t. the grid), their plain
forms, and the autograd function that joins them.

Kernels: csrc/warp.cu, csrc/warp_dsrc.cu and csrc/warp_dgrid.cu, CUDA C++ for
sm_90a. They replace the three TPU kernels of
monkeynet_tpu/ops/pallas/warp.py (`_warp_fwd_impl`, and the d_src and d_grid
`pallas_call`s of `_warp_bwd`). The TPU kernels turn the gather and the
scatter into separable hat-matrix matmuls over tiles of 256 points, and fall
back to XLA past an 8 MB source, because the TPU has neither. Hopper has
both, so none of that carries over:

- forward: a direct four-tap gather, one thread per (output point, 4
  channels), coordinates and weights in f32, operand f32 or bf16, f32
  accumulation;
- d_src: the same threads scatter `dout * w_corner` with f32 atomicAdd into
  a zeroed f32 buffer, cast to the source's dtype afterwards. Atomics add in
  no fixed order, so two runs agree to f32 rounding of each pixel's sum
  (about 1e-6 of the largest term), not bit for bit;
- d_grid: one warp per output point, lanes striding over channels, the
  right difference at integer coordinates, f32 throughout.
All three are bound by bytes: grids, outputs and gradients cross DRAM once,
and the source planes of the main paths fit in the 50 MB L2.

`grid_sample` is the plain version of the forward, the four-corner gather of
monkeynet_tpu/ops/sampling.py; its autograd is the plain version of both
gradients (`warp_dsrc_plain`, `warp_dgrid_plain`). `warp` takes `grid_sample`
for a CPU tensor; for a CUDA tensor it goes through `WarpFunction`, whose
forward and backward launch the kernels, so a CUDA tensor that requires grad
never gets a result without a `grad_fn`.
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.ops.cuda import _build

SOURCE = "monkeynet_tpu_torch/csrc/warp.cu"
REPLACES = "monkeynet_tpu/ops/pallas/warp.py:213"
DSRC_SOURCE = "monkeynet_tpu_torch/csrc/warp_dsrc.cu"
DSRC_REPLACES = "monkeynet_tpu/ops/pallas/warp.py:240"
DGRID_SOURCE = "monkeynet_tpu_torch/csrc/warp_dgrid.cu"
DGRID_REPLACES = "monkeynet_tpu/ops/pallas/warp.py:257"


def grid_sample(image, grid):
    """Bilinear sampling of `image` at `grid` locations (plain PyTorch).

    Args:
      image: (B, H, W, C) float tensor.
      grid:  (B, Ho, Wo, 2) xy coordinates in [-1, 1]; align_corners=True
             (-1 maps to pixel 0, +1 to pixel N-1).

    Out-of-range corners contribute zero (zeros padding). Corner weights are
    cast to the image's dtype, as the JAX reference does.

    Returns:
      (B, Ho, Wo, C).
    """
    B, H, W, C = image.shape
    dtype = image.dtype
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = (x - x0).to(dtype)
    wx0 = 1.0 - wx1
    wy1 = (y - y0).to(dtype)
    wy0 = 1.0 - wy1
    flat = image.reshape(B, H * W, C)

    def corner(xi, yi, wgt):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        idx = (yc * W + xc).reshape(B, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx).reshape(xi.shape + (C,))
        w_eff = torch.where(valid, wgt, torch.zeros_like(wgt))
        return vals * w_eff[..., None]

    return (
        corner(x0, y0, wx0 * wy0)
        + corner(x1, y0, wx1 * wy0)
        + corner(x0, y1, wx0 * wy1)
        + corner(x1, y1, wx1 * wy1)
    )


def warp_dsrc_plain(grid, dout, image_shape):
    """Plain d_src: autograd of `grid_sample` w.r.t. an image of
    `image_shape` (B, H, W, C), in dout's dtype. The warp is linear in the
    image, so the gradient does not depend on its values."""
    image = torch.zeros(image_shape, dtype=dout.dtype, device=dout.device, requires_grad=True)
    with torch.enable_grad():
        out = grid_sample(image, grid.detach())
    return torch.autograd.grad(out, image, dout)[0]


def warp_dgrid_plain(image, grid, dout):
    """Plain d_grid: autograd of `grid_sample` w.r.t. the grid. floor() and
    the range masks carry no gradient, so at an integer coordinate this is
    the right difference."""
    grid = grid.detach().requires_grad_()
    with torch.enable_grad():
        out = grid_sample(image.detach(), grid)
    return torch.autograd.grad(out, grid, dout)[0]


def _check_pair(image, grid, name):
    _build.require_cuda_tensor(image, f"{name} image", _build.DTYPE_CODES, 4)
    _build.require_cuda_tensor(grid, f"{name} grid", (torch.float32,), 4)
    if grid.shape[0] != image.shape[0] or grid.shape[-1] != 2 or grid.device != image.device:
        raise ValueError(
            f"{name}: grid {tuple(grid.shape)} on {grid.device} does not match "
            f"image {tuple(image.shape)} on {image.device}"
        )


def _check_dout(dout, grid, C, dtypes, name):
    _build.require_cuda_tensor(dout, f"{name} dout", dtypes, 4)
    if tuple(dout.shape) != tuple(grid.shape[:3]) + (C,) or dout.device != grid.device:
        raise ValueError(
            f"{name}: dout {tuple(dout.shape)} on {dout.device} does not match grid "
            f"{tuple(grid.shape)} on {grid.device} and {C} channels"
        )


def _vec(C, *tensors):
    """Channels per thread: 4 when C and every pointer allow aligned vectors."""
    ok = C % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)
    return 4 if ok else 1


def _warp_forward(image, grid):
    """Launch the forward kernel: image (B, H, W, C) f32 or bf16, grid
    (B, Ho, Wo, 2) f32, both contiguous CUDA tensors."""
    _check_pair(image, grid, "warp")
    B, H, W, C = image.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    lib = _build.library()
    with torch.cuda.device(image.device):
        status = lib.mk_warp_fwd(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C,
            Ho * Wo, _build.DTYPE_CODES[image.dtype], _vec(C, image, out),
            _build.stream_of(image),
        )
    _build.check_launch(status, "warp")
    warp.launches += 1
    return out


def warp_dsrc(grid, dout, image_shape):
    """Gradient of the warp w.r.t. its image, (B, H, W, C) in dout's dtype:
    the d_src kernel for CUDA tensors, plain on the CPU.

    grid (B, Ho, Wo, 2) f32 and dout (B, Ho, Wo, C) f32 or bf16, contiguous.
    """
    if dout.device.type == "cpu":
        return warp_dsrc_plain(grid, dout, image_shape)
    B, H, W, C = image_shape
    _build.require_cuda_tensor(grid, "warp_dsrc grid", (torch.float32,), 4)
    if grid.shape[0] != B or grid.shape[-1] != 2:
        raise ValueError(f"warp_dsrc: grid {tuple(grid.shape)} does not match image {image_shape}")
    _check_dout(dout, grid, C, _build.DTYPE_CODES, "warp_dsrc")
    acc = torch.empty((B, H, W, C), dtype=torch.float32, device=dout.device)  # zeroed by the launcher
    lib = _build.library()
    with torch.cuda.device(dout.device):
        status = lib.mk_warp_dsrc(
            grid.data_ptr(), dout.data_ptr(), acc.data_ptr(), B, H, W, C,
            grid.shape[1] * grid.shape[2], _build.DTYPE_CODES[dout.dtype],
            _vec(C, dout, acc), _build.stream_of(dout),
        )
    _build.check_launch(status, "warp_dsrc")
    warp_dsrc.launches += 1
    return acc.to(dout.dtype)


warp_dsrc.launches = 0


def warp_dgrid(image, grid, dout):
    """Gradient of the warp w.r.t. its grid, (B, Ho, Wo, 2) f32: the d_grid
    kernel for CUDA tensors, plain on the CPU.

    image (B, H, W, C) and dout (B, Ho, Wo, C) share a dtype, f32 or bf16;
    grid (B, Ho, Wo, 2) f32; all contiguous.
    """
    if image.device.type == "cpu":
        return warp_dgrid_plain(image, grid, dout)
    _check_pair(image, grid, "warp_dgrid")
    B, H, W, C = image.shape
    _check_dout(dout, grid, C, (image.dtype,), "warp_dgrid")
    dgrid = torch.empty(grid.shape, dtype=torch.float32, device=image.device)
    lib = _build.library()
    with torch.cuda.device(image.device):
        status = lib.mk_warp_dgrid(
            image.data_ptr(), grid.data_ptr(), dout.data_ptr(), dgrid.data_ptr(), B, H, W, C,
            grid.shape[1] * grid.shape[2], _build.DTYPE_CODES[image.dtype],
            _build.stream_of(image),
        )
    _build.check_launch(status, "warp_dgrid")
    warp_dgrid.launches += 1
    return dgrid


warp_dgrid.launches = 0


class WarpFunction(torch.autograd.Function):
    """The warp on CUDA tensors with both gradients as kernels. A gradient
    that autograd does not ask for (the raw source frame needs none) costs
    no launch."""

    @staticmethod
    def forward(ctx, image, grid):
        ctx.save_for_backward(image, grid)
        return _warp_forward(image, grid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        image, grid = ctx.saved_tensors
        dout = dout.contiguous()
        d_image = d_grid = None
        if ctx.needs_input_grad[0]:
            d_image = warp_dsrc(grid, dout, tuple(image.shape))
        if ctx.needs_input_grad[1]:
            d_grid = warp_dgrid(image, grid, dout)
        return d_image, d_grid


def warp(image, grid):
    """grid_sample through the kernels for CUDA tensors (differentiable
    through `WarpFunction`), plain on the CPU.

    image (B, H, W, C) f32 or bf16, grid (B, Ho, Wo, 2) f32, both
    contiguous -> (B, Ho, Wo, C) in the image's dtype.
    """
    if image.device.type == "cpu":
        return grid_sample(image, grid)
    return WarpFunction.apply(image, grid)


warp.launches = 0
