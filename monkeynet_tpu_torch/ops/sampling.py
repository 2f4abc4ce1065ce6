"""Sampling and resize primitives with the reference's semantics.

Counterpart of monkeynet_tpu/ops/sampling.py: bilinear sampling with
align_corners=True and zeros padding, and torch's legacy `nearest` resize
(src = floor(dst * in / out)). Layouts are channels-last:
  images   (B, H, W, C)
  videos   (B, D, H, W, C)
  grids    (..., 2) in xy order, [-1, 1]
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.ops.cuda.warp import grid_sample, warp

__all__ = [
    "grid_sample",
    "warp_video",
    "shift_sample",
    "resize_nearest",
    "resize_bilinear",
    "resize_video",
]


def warp_video(source, grid):
    """Warp a single-frame source with a per-frame sampling grid.

    The source has one frame, so the reference's 3-D sampling with a zero z
    coordinate is 2-D bilinear sampling of that frame for every output
    frame. On a CUDA tensor this runs the warp kernels, forward and backward
    (`WarpFunction`).

    Args:
      source: (B, H, W, C) source-frame features.
      grid:   (B, D, Ho, Wo, 2) f32 xy sampling grid per output frame.

    Returns:
      (B, D, Ho, Wo, C)
    """
    B, D, Ho, Wo, _ = grid.shape
    out = warp(source.contiguous(), grid.reshape(B, D * Ho, Wo, 2).contiguous())
    return out.reshape(B, D, Ho, Wo, -1)


def _shift_matrices(offsets, size):
    """Bilinear 1-D shift operators: offsets (..., N) in pixels ->
    (..., N, size, size) matrices R with (R @ v)[i] = lerp(v[i+k], v[i+k+1], f)
    where offset = k + f; out-of-range taps contribute zero."""
    k = torch.floor(offsets)
    f = (offsets - k)[..., None, None]
    k = k[..., None, None].long()
    idx = torch.arange(size, device=offsets.device)
    rows, cols = idx[:, None], idx[None, :]
    src = rows + k
    return (cols == src) * (1.0 - f) + (cols == src + 1) * f


def shift_sample(image, shifts):
    """Sample `image` at constant per-slot translations.

    Equal to grid_sample(image, coordinate_grid + shift) for a constant
    shift: the per-keypoint shifted source copies of the movement embedding.
    A constant translation makes bilinear sampling separable, so it is two
    batched matmuls with 1-D shift matrices.

    Args:
      image:  (B, H, W, C).
      shifts: (B, N, 2) xy in normalised [-1, 1] units.

    Returns:
      (B, N, H, W, C), zeros padding outside the source.
    """
    B, H, W, C = image.shape
    dtype = image.dtype
    off_x = shifts[..., 0] * 0.5 * (W - 1)
    off_y = shifts[..., 1] * 0.5 * (H - 1)
    Ry = _shift_matrices(off_y, H).to(dtype)  # (B, N, H, H)
    Rx = _shift_matrices(off_x, W).to(dtype)  # (B, N, W, W)
    tmp = torch.einsum("bnxX,bhXc->bnhxc", Rx, image)
    return torch.einsum("bnyY,bnYxc->bnyxc", Ry, tmp)


def resize_nearest(x, out_hw):
    """Legacy-nearest spatial resize of (..., H, W, C) to out_hw:
    src = floor(dst * in / out)."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    rows = torch.div(torch.arange(Ho, device=x.device) * H, Ho, rounding_mode="floor")
    cols = torch.div(torch.arange(Wo, device=x.device) * W, Wo, rounding_mode="floor")
    return x.index_select(-3, rows).index_select(-2, cols)


def _linear_weights(in_size, out_size, device):
    """Half-pixel source indices and lerp weights for one axis."""
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = torch.floor(src).long().clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    return lo, hi, src - lo.float()


def resize_bilinear(x, out_hw):
    """Half-pixel bilinear spatial resize of (..., H, W, C), the reference's
    'trilinear' flow resize with the frame count unchanged."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    rlo, rhi, rw = _linear_weights(H, Ho, x.device)
    clo, chi, cw = _linear_weights(W, Wo, x.device)
    rw = rw.to(x.dtype)[:, None, None]
    cw = cw.to(x.dtype)[:, None]
    x = x.index_select(-3, rlo) * (1.0 - rw) + x.index_select(-3, rhi) * rw
    return x.index_select(-2, clo) * (1.0 - cw) + x.index_select(-2, chi) * cw


def resize_video(x, out_hw, mode="nearest"):
    """The config's `interpolation_mode`: 'nearest', or 'trilinear' /
    'bilinear' for the half-pixel bilinear resize."""
    if mode == "nearest":
        return resize_nearest(x, out_hw)
    if mode in ("trilinear", "bilinear"):
        return resize_bilinear(x, out_hw)
    raise ValueError(f"unknown interpolation mode: {mode}")
