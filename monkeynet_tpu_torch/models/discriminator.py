"""Pix2Pix-style patch discriminator over videos.

Counterpart of monkeynet_tpu/models/discriminator.py: optional nearest
pre-downscale; the kp-embedding heatmaps concatenated onto the input, the
concat carried at a multiple of 8 channels (blocks.carried);
`num_blocks` down blocks, each a VALID (1, 4, 4) conv, InstanceNorm on every
block but the first, leaky-relu 0.2 and (1, 2, 2) avg-pool; a 1x1 score conv.
Returns every map, [input, feat_1, ..., feat_n, score], for the
feature-matching reconstruction loss. Every kernel has depth 1, so the frames
fold into the conv batch as in the other networks.

State-dict names are the reference checkpoint's: `down_blocks.i.conv`,
`down_blocks.i.norm`, `conv` (the score head); the kp embedding has no
parameters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from monkeynet_tpu_torch.models.blocks import Conv3D, InstanceNorm, avg_pool_2x2, carried, cat_carried
from monkeynet_tpu_torch.models.movement_embedding import MovementEmbedding
from monkeynet_tpu_torch.ops.sampling import resize_nearest


class DiscDownBlock(nn.Module):
    """VALID (1, k, k) conv -> [InstanceNorm] -> leaky-relu(0.2) -> avg-pool."""

    def __init__(self, in_features: int, out_features: int, norm: bool = False,
                 kernel_size: int = 4, carried_in: Optional[int] = None):
        super().__init__()
        self.conv = Conv3D(in_features, out_features, (1, kernel_size, kernel_size), (0, 0, 0),
                           carried_in=carried_in)
        self.norm = InstanceNorm(out_features) if norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return avg_pool_2x2(F.leaky_relu(x, 0.2))


class Discriminator(nn.Module):
    def __init__(self, num_channels: int = 3, num_kp: int = 10,
                 kp_variance: Union[str, float] = 0.01, scale_factor: float = 1.0,
                 block_expansion: int = 64, num_blocks: int = 4, max_features: int = 512,
                 kp_embedding_params: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.kp_embedding = None
        in_features = width = num_channels
        if kp_embedding_params is not None:
            self.kp_embedding = MovementEmbedding(
                num_kp=num_kp, kp_variance=kp_variance, num_channels=num_channels,
                **kp_embedding_params,
            )
            in_features += self.kp_embedding.out_channels
            width = carried(in_features)
        self.in_width = width
        blocks = []
        for i in range(num_blocks):
            out_features = min(max_features, block_expansion * (2 ** (i + 1)))
            blocks.append(DiscDownBlock(in_features, out_features, norm=(i != 0),
                                        carried_in=width if i == 0 else None))
            in_features = out_features
        self.down_blocks = nn.ModuleList(blocks)
        self.conv = Conv3D(in_features, 1, (1, 1, 1), (0, 0, 0))

    def forward(self, x, kp_driving, kp_source) -> List[torch.Tensor]:
        """x: (B, D, H, W, C) video. Returns [x, feat_1..feat_n, score]."""
        out_maps = [x]
        if self.scale_factor != 1:
            H, W = x.shape[-3], x.shape[-2]
            x = resize_nearest(x, (int(H * self.scale_factor), int(W * self.scale_factor)))
        out = x
        if self.kp_embedding is not None:
            out = cat_carried([x, self.kp_embedding(x, kp_driving, kp_source)], self.in_width)
        for block in self.down_blocks:
            out = block(out)
            out_maps.append(out)
        out_maps.append(self.conv(out))
        return out_maps
