"""Bilinear warp, align_corners=True with zeros padding: kernel and plain form.

Kernel: csrc/warp.cu, CUDA C++ for sm_90a. It replaces the TPU forward
kernel of monkeynet_tpu/ops/pallas/warp.py (`_warp_fwd_impl`, the
`pallas_call` of `_fwd_kernel`). The TPU kernel turns the gather into two
separable hat-matrix matmuls, and falls back to XLA's gather past an 8 MB
source, because the TPU has no fast vector gather. Hopper has one, so the
kernel is a direct four-tap gather with no size envelope: one thread per
(output point, 4 channels), coordinates and weights in f32, operand f32 or
bf16, f32 accumulation. It is bound by bytes: the grid and the output cross
DRAM once, and the source planes of the main path fit in the 50 MB L2.

`grid_sample` is the plain version, the four-corner gather of
monkeynet_tpu/ops/sampling.py; `warp` takes it for a CPU tensor and launches
the kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.ops.cuda import _build

SOURCE = "monkeynet_tpu_torch/csrc/warp.cu"
REPLACES = "monkeynet_tpu/ops/pallas/warp.py:213"


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


def warp(image, grid):
    """grid_sample through the kernel for CUDA tensors, plain on the CPU.

    image (B, H, W, C) f32 or bf16, grid (B, Ho, Wo, 2) f32, both
    contiguous -> (B, Ho, Wo, C) in the image's dtype.
    """
    if image.device.type == "cpu":
        return grid_sample(image, grid)
    _build.require_cuda_tensor(image, "warp image", _build.DTYPE_CODES, 4)
    _build.require_cuda_tensor(grid, "warp grid", (torch.float32,), 4)
    B, H, W, C = image.shape
    if grid.shape[0] != B or grid.shape[-1] != 2 or grid.device != image.device:
        raise ValueError(
            f"warp: grid {tuple(grid.shape)} on {grid.device} does not match "
            f"image {tuple(image.shape)} on {image.device}"
        )
    Ho, Wo = grid.shape[1], grid.shape[2]
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    align = 4 * image.element_size()
    vec = 4 if (C % 4 == 0 and image.data_ptr() % align == 0
                and out.data_ptr() % align == 0) else 1
    lib = _build.library()
    with torch.cuda.device(image.device):
        status = lib.mk_warp_fwd(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C,
            Ho * Wo, _build.DTYPE_CODES[image.dtype], vec, _build.stream_of(image),
        )
    _build.check_launch(status, "warp")
    warp.launches += 1
    return out


warp.launches = 0
