"""Bilinear warp, align_corners=True with zeros padding: its three kernels
(forward, gradient w.r.t. the source, gradient w.r.t. the grid), their plain
forms, the launch plans of the forward and of d_grid, and the autograd
function that joins them.

Kernels: csrc/warp.cu, csrc/warp_dsrc.cu and csrc/warp_dgrid.cu, CUDA C++ for
sm_90a. They replace the three TPU kernels of
monkeynet_tpu/ops/pallas/warp.py (`_warp_fwd_impl`, and the d_src and d_grid
`pallas_call`s of `_warp_bwd`). The TPU kernels turn the gather and the
scatter into separable hat-matrix matmuls over tiles of 256 points, and fall
back to XLA past an 8 MB source, because the TPU has neither. Hopper has
both, so none of that carries over:

- forward: a direct four-tap gather, coordinates and weights in f32, operand
  f32 or bf16, f32 accumulation. `warp_plan` picks 'small' (C <= 4: one
  thread per point carries every channel; a source plane of up to 48 KB is
  staged in shared memory) or 'vector' (a power-of-two group of threads per
  point, 16-byte packs of channels);
- d_src: one thread per (output point, 4 channels) scatters `dout * w_corner`
  with f32 atomicAdd into a zeroed f32 buffer, cast to the source's dtype
  afterwards. Atomics add in no fixed order, so two runs agree to f32
  rounding of each pixel's sum (about 1e-6 of the largest term), not bit for
  bit;
- d_grid: the right difference at integer coordinates, f32 throughout.
  `dgrid_plan` picks 'small' (one thread per point), 'grouped' (up to 32
  threads per point on 16-byte packs, a segmented shuffle sum) or 'split'
  (several warps per point, partials added in shared memory in a fixed
  order), so the result does not change from run to run.
All three are bound by bytes: grids, outputs and gradients cross DRAM once,
and the source planes of the main paths fit in the 50 MB L2. The plans are
plain Python, decided from the shape, the dtype and the pointers' alignment
before the launch; a refused launch raises.

`grid_sample` is the plain version of the forward, the four-corner gather of
monkeynet_tpu/ops/sampling.py; its autograd is the plain version of both
gradients (`warp_dsrc_plain`, `warp_dgrid_plain`). `warp` takes `grid_sample`
for a CPU tensor; for a CUDA tensor it goes through `WarpFunction`, whose
forward and backward launch the kernels, so a CUDA tensor that requires grad
never gets a result without a `grad_fn`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monkeynet_tpu_torch.ops.cuda import _build

SOURCE = "monkeynet_tpu_torch/csrc/warp.cu"
REPLACES = "monkeynet_tpu/ops/pallas/warp.py:213"
DSRC_SOURCE = "monkeynet_tpu_torch/csrc/warp_dsrc.cu"
DSRC_REPLACES = "monkeynet_tpu/ops/pallas/warp.py:240"
DGRID_SOURCE = "monkeynet_tpu_torch/csrc/warp_dgrid.cu"
DGRID_REPLACES = "monkeynet_tpu/ops/pallas/warp.py:257"

MAX_THREADS = 1024
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65535
SMALL_C = 4  # kSmallC in csrc/warp.cu and csrc/warp_dgrid.cu
SMS = 132  # streaming multiprocessors of an H100 SXM
# Threads an H100 holds resident at once (2048 an SM).
FULL_WAVE = SMS * 2048
# A lane takes two packs of a point while that leaves this many threads,
# else one: measured on an H100 at the taichi shapes, two packs a lane win
# wherever the launch stays this large, and lose to more threads below it
# (PERF.md).
_TWO_PACKS_MIN_THREADS = 65536
_THREADS = 256
# The 'small' forward stages a source plane of at most this many bytes in
# shared memory (the taichi source frame, 64 x 64 x 3 f32, is 48 KB), with
# one block of 1024 threads an SM walking the points.
_STAGE_MAX_BYTES = 48 * 1024
_STAGE_THREADS = 1024
_FWD_VARIANTS = ("small", "vector")
_DGRID_VARIANTS = ("small", "grouped", "split")


class WarpPlan(NamedTuple):
    """How csrc/warp.cu runs one forward call."""

    variant: str  # 'small' | 'vector'
    vector: int  # channels one load moves: 16 bytes' worth (4 f32, 8 bf16) or 1
    lanes: int  # threads per point, a power of two
    threads: int  # threads per block
    blocks: tuple  # (x over a batch element's points, y = batch element)
    index_bits: int  # 32, or 64 where an element offset reaches 2^31
    shared_bytes: int  # the source plane staged in shared memory; 0: read in place


class DgridPlan(NamedTuple):
    """How csrc/warp_dgrid.cu runs one d_grid call."""

    variant: str  # 'small' | 'grouped' | 'split'
    vector: int
    lanes: int  # threads per point: 1 ('small'), <= 32 ('grouped'), 64-1024 ('split')
    threads: int
    blocks: tuple
    index_bits: int


def _next_pow2(n):
    return 1 << max(0, n - 1).bit_length()


def _pack(C, dtype, aligned):
    """Channels a load moves: a 16-byte pack where C is a multiple of it and
    every operand pointer is 16-byte aligned, else 1."""
    v = 16 // dtype.itemsize
    return v if aligned and C % v == 0 else 1


def _launch(B, N, C, source_pixels, per_block, variant, blocks_x=None):
    """(blocks, index bits): blocks over a batch element's points (one per
    `per_block` points, unless the kernel walks them grid-stride with
    `blocks_x` blocks) and the batch elements; 32-bit offsets while every
    element offset the kernel forms (source plane, grid / dout / output rows,
    a point index one stride past the last point) stays below 2^31."""
    if blocks_x is None:
        blocks_x = -(-N // per_block)
    if B > MAX_GRID_Y or blocks_x > MAX_GRID_X:
        raise ValueError(f"{variant}: {B} batch elements of {N} points exceed the launch grid")
    largest = max(B * source_pixels * C, B * N * max(C, 2), N + blocks_x * per_block)
    return (blocks_x, B), 32 if largest < 2**31 else 64


def _lanes(B, N, packs):
    """Threads per point for `packs` packs a point: two packs a lane while
    B x N x lanes stays >= 65536, else one; a power of two."""
    two = _next_pow2(-(-packs // 2))
    return two if B * N * two >= _TWO_PACKS_MIN_THREADS else _next_pow2(packs)


def warp_plan(B, N, C, dtype, aligned, source_pixels) -> WarpPlan:
    """Variant, pack, threads per point and launch shape of the forward
    kernel for a (B, H, W, C) source of `dtype` with H * W = `source_pixels`,
    sampled at B x N points. `aligned`: whether the source and the output
    start on 16 bytes.

    C <= 4 is 'small': one thread per point. Where the source plane fits
    48 KB and a batch element has at least 1024 points, the plane is staged
    in shared memory and a block of 1024 threads an SM walks the points
    (the gathers then come from shared memory). Otherwise 'vector', with
    `_lanes` threads per point, at most a block of 256."""
    if C <= SMALL_C:
        plane = source_pixels * C * dtype.itemsize
        if plane <= _STAGE_MAX_BYTES and N >= _STAGE_THREADS:
            tiles = -(-N // _STAGE_THREADS)
            blocks, index_bits = _launch(B, N, C, source_pixels, _STAGE_THREADS, "warp",
                                         blocks_x=min(tiles, max(1, SMS // B)))
            return WarpPlan("small", 1, 1, _STAGE_THREADS, blocks, index_bits,
                            -(-plane // 16) * 16)
        variant, vector, lanes = "small", 1, 1
    else:
        variant, vector = "vector", _pack(C, dtype, aligned)
        lanes = min(_THREADS, _lanes(B, N, C // vector))
    blocks, index_bits = _launch(B, N, C, source_pixels, _THREADS // lanes, "warp")
    return WarpPlan(variant, vector, lanes, _THREADS, blocks, index_bits, 0)


def dgrid_plan(B, N, C, dtype, aligned, source_pixels) -> DgridPlan:
    """Variant, pack, threads per point and launch shape of the d_grid
    kernel for a (B, H, W, C) source of `dtype` with H * W =
    `source_pixels`, B x N points. `aligned`: whether the source and dout
    start on 16 bytes.

    C <= 4 is 'small': one thread per point. Otherwise `_lanes` threads per
    point: 'grouped' while they are at most 32; 'split' above, which only a
    point with more packs than a warp has lanes reaches, and only on a
    launch that 32 lanes a point would not fill (else 'grouped' with 32
    lanes, several packs each)."""
    if C <= SMALL_C:
        variant, vector, lanes = "small", 1, 1
    else:
        vector = _pack(C, dtype, aligned)
        lanes = min(MAX_THREADS, _lanes(B, N, C // vector))
        if lanes > 32 and B * N * 32 >= FULL_WAVE:
            lanes = 32
        variant = "split" if lanes > 32 else "grouped"
    threads = max(_THREADS, lanes)
    blocks, index_bits = _launch(B, N, C, source_pixels, threads // lanes, "warp_dgrid")
    return DgridPlan(variant, vector, lanes, threads, blocks, index_bits)


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
    """d_src's channels per thread: 4 when C and every pointer allow aligned
    vectors."""
    ok = C % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)
    return 4 if ok else 1


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_forward(image, grid, out, plan):
    """Run the forward kernel under `plan` into `out`."""
    B, H, W, C = image.shape
    lib = _build.library()
    with torch.cuda.device(image.device):
        status = lib.mk_warp_fwd(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C,
            grid.shape[1] * grid.shape[2], _build.DTYPE_CODES[image.dtype],
            _FWD_VARIANTS.index(plan.variant), plan.vector, plan.lanes.bit_length() - 1,
            plan.threads, plan.blocks[0], plan.shared_bytes, int(plan.index_bits == 64),
            _build.stream_of(image),
        )
    _build.check_launch(status, f"warp ({plan.variant})")


def _warp_forward(image, grid):
    """Launch the forward kernel: image (B, H, W, C) f32 or bf16, grid
    (B, Ho, Wo, 2) f32, both contiguous CUDA tensors."""
    _check_pair(image, grid, "warp")
    B, H, W, C = image.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    plan = warp_plan(B, Ho * Wo, C, image.dtype, _aligned(image, out), H * W)
    _launch_forward(image, grid, out, plan)
    warp.launches += 1
    warp.launches_by_variant[plan.variant] += 1
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


def _launch_dgrid(image, grid, dout, dgrid, plan):
    """Run the d_grid kernel under `plan` into `dgrid`."""
    B, H, W, C = image.shape
    lib = _build.library()
    with torch.cuda.device(image.device):
        status = lib.mk_warp_dgrid(
            image.data_ptr(), grid.data_ptr(), dout.data_ptr(), dgrid.data_ptr(), B, H, W, C,
            grid.shape[1] * grid.shape[2], _build.DTYPE_CODES[image.dtype],
            _DGRID_VARIANTS.index(plan.variant), plan.vector, plan.lanes.bit_length() - 1,
            plan.threads, plan.blocks[0], int(plan.index_bits == 64), _build.stream_of(image),
        )
    _build.check_launch(status, f"warp_dgrid ({plan.variant})")


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
    plan = dgrid_plan(B, grid.shape[1] * grid.shape[2], C, image.dtype,
                      _aligned(image, dout), H * W)
    _launch_dgrid(image, grid, dout, dgrid, plan)
    warp_dgrid.launches += 1
    warp_dgrid.launches_by_variant[plan.variant] += 1
    return dgrid


warp_dgrid.launches = 0
warp_dgrid.launches_by_variant = dict.fromkeys(_DGRID_VARIANTS, 0)


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
warp.launches_by_variant = dict.fromkeys(_FWD_VARIANTS, 0)
