"""Keypoint <-> gaussian-heatmap transforms (plain PyTorch).

Counterpart of monkeynet_tpu/ops/gaussian.py. Keypoints are
    kp = {'mean': (B, D, K, 2) xy in [-1, 1],
          'var':  (B, D, K, 2, 2)}   # (B, D, K, 1, 1) in 'single' mode
kp2gaussian returns (B, D, K, H, W); gaussian2kp consumes (B, D, H, W, K),
the channels-last output of the hourglass.

Keypoint math always runs in float32 whatever the network's dtype: a bf16
2x2 determinant cancels to zero and flips the exponent's sign, and bf16
quantises positions by ~0.25 px at 64^2. Both transforms upcast and return
float32; callers cast dense outputs back where they join conv inputs.
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.ops.grid import make_coordinate_grid, mat2_smallest_singular


def kp2gaussian(kp, spatial_size, kp_variance="matrix"):
    """Render keypoints as (B, D, K, H, W) f32 gaussian heatmaps that peak
    at 1 on the keypoint mean. kp_variance: 'matrix' | 'single' | float."""
    mean = kp["mean"].float()
    h, w = spatial_size
    grid = make_coordinate_grid((h, w), dtype=mean.dtype, device=mean.device)
    dx = grid[None, None, None, :, :, 0] - mean[:, :, :, None, None, 0]
    dy = grid[None, None, None, :, :, 1] - mean[:, :, :, None, None, 1]

    if kp_variance == "matrix":
        # (g - mu)^T Sigma^-1 (g - mu) with Sigma = [[a, b], [c, d]],
        # expanded elementwise and divided by det once at the end.
        var = kp["var"].float()
        a = var[..., 0, 0][:, :, :, None, None]
        b = var[..., 0, 1][:, :, :, None, None]
        c = var[..., 1, 0][:, :, :, None, None]
        d = var[..., 1, 1][:, :, :, None, None]
        det = a * d - b * c
        under_exp = (d * dx * dx - (b + c) * dx * dy + a * dy * dy) / det
        return torch.exp(-0.5 * under_exp)
    if kp_variance == "single":
        var = kp["var"].float()[..., 0, 0][:, :, :, None, None]
        return torch.exp(-0.5 * (dx * dx + dy * dy) / var)
    return torch.exp(-0.5 * (dx * dx + dy * dy) / kp_variance)


def gaussian2kp(heatmap, kp_variance="matrix", clip_variance=None):
    """Soft-argmax a softmaxed (B, D, H, W, K) heatmap into an f32 keypoint
    dict {'mean', ['var']}.

    The +1e-7 floor is added after the softmax and the mean is not
    renormalised, as the reference does. clip_variance clamps the
    covariance's smallest singular value from below by rescaling.
    """
    B, D, H, W, K = heatmap.shape
    heatmap = heatmap.float() + 1e-7
    grid = make_coordinate_grid((H, W), dtype=heatmap.dtype, device=heatmap.device)
    mean = torch.einsum("bdhwk,hwc->bdkc", heatmap, grid)
    kp = {"mean": mean}

    if kp_variance == "matrix":
        mean_sub = grid[None, None, :, :, None, :] - mean[:, :, None, None, :, :]
        var = torch.einsum("bdhwki,bdhwkj,bdhwk->bdkij", mean_sub, mean_sub, heatmap)
        if clip_variance:
            var = clip_covariance(var, clip_variance)
        kp["var"] = var
    elif kp_variance == "single":
        mean_sub = grid[None, None, :, :, None, :] - mean[:, :, None, None, :, :]
        var = torch.einsum("bdhwki,bdhwk->bdki", mean_sub**2, heatmap)
        kp["var"] = var.mean(dim=-1)[..., None, None]
    return kp


def clip_covariance(var, clip_variance):
    """Rescale (..., 2, 2) covariances so their smallest singular value is at
    least clip_variance."""
    sg = mat2_smallest_singular(var)[..., None]
    return torch.clamp(sg, min=clip_variance) * var / sg


def spatial_softmax(x, temperature=1.0):
    """Softmax over the (H, W) dims of a (B, D, H, W, K) heatmap, in f32."""
    B, D, H, W, K = x.shape
    flat = x.float().reshape(B, D, H * W, K) / temperature
    return torch.softmax(flat, dim=2).reshape(B, D, H, W, K)
