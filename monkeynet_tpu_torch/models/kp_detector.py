"""Unsupervised keypoint detector.

Counterpart of monkeynet_tpu/models/kp_detector.py: optional nearest
pre-downscale, hourglass -> per-kp heatmap logits, temperature softmax and
soft-argmax to the mean and covariance (clipped), f32.

The module's mode picks the soft-argmax, as the JAX package's `train` flag
does: in eval mode it is the softargmax kernel (on a CUDA tensor), which is
forward-only; in training mode it is `spatial_softmax` and `gaussian2kp` in
plain PyTorch, which autograd differentiates.
"""

from __future__ import annotations

from typing import Optional, Union

from torch import nn

from monkeynet_tpu_torch.models.blocks import Hourglass
from monkeynet_tpu_torch.ops.cuda.softargmax import softargmax
from monkeynet_tpu_torch.ops.gaussian import gaussian2kp, spatial_softmax
from monkeynet_tpu_torch.ops.sampling import resize_nearest


class KPDetector(nn.Module):
    """Video (B, D, H, W, C) -> {'mean': (B,D,K,2), 'var': (B,D,K,2,2)}."""

    def __init__(self, block_expansion: int, num_kp: int, num_channels: int,
                 max_features: int, num_blocks: int, temperature: float,
                 kp_variance: Union[str, float], scale_factor: float = 1.0,
                 clip_variance: Optional[float] = None):
        super().__init__()
        self.temperature = temperature
        self.kp_variance = kp_variance
        self.scale_factor = scale_factor
        self.clip_variance = clip_variance
        self.predictor = Hourglass(
            block_expansion, num_channels, num_kp, num_blocks, max_features
        )

    def forward(self, x):
        if self.scale_factor != 1:
            H, W = x.shape[-3], x.shape[-2]
            x = resize_nearest(
                x, (int(H * self.scale_factor), int(W * self.scale_factor))
            )
        heatmap = self.predictor(x)
        if self.training:
            heatmap = spatial_softmax(heatmap, self.temperature)
            return gaussian2kp(heatmap, self.kp_variance, self.clip_variance)
        return softargmax(
            heatmap.contiguous(), self.temperature, self.kp_variance, self.clip_variance
        )
