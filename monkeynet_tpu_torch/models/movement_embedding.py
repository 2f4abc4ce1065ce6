"""Keypoint movement embedding: kp pairs -> dense conditioning maps.

Counterpart of monkeynet_tpu/models/movement_embedding.py. For each keypoint
(after an optional background slot) the embedding stacks, interleaved per
keypoint:

    [ heatmap (1ch) | kp difference (2ch) | shifted source (C ch) ]

The per-keypoint interleave is load-bearing: the dense-motion module's
grouped 1x1 convs (groups = K+1) assume it. Output (B, D, H, W, Kb * cpk).

The module's mode picks the heatmap renderer, as the JAX package's `train`
flag does: in eval mode it is the heatmap kernel (on CUDA keypoints), which
is forward-only; in training mode it is `heatmap_plain`, which autograd
differentiates.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from monkeynet_tpu_torch.ops.cuda.heatmap import heatmap as heatmap_kernel
from monkeynet_tpu_torch.ops.cuda.heatmap import heatmap_plain
from monkeynet_tpu_torch.ops.sampling import resize_nearest, shift_sample


class MovementEmbedding(nn.Module):
    def __init__(self, num_kp: int, kp_variance: Union[str, float], num_channels: int,
                 use_deformed_source_image: bool = False, use_difference: bool = False,
                 use_heatmap: bool = True, add_bg_feature_map: bool = False,
                 heatmap_type: str = "gaussian", norm_const: Union[str, float] = "sum",
                 scale_factor: float = 1.0):
        super().__init__()
        if heatmap_type not in ("gaussian", "difference"):
            raise ValueError(f"bad heatmap_type {heatmap_type}")
        self.num_kp = num_kp
        self.kp_variance = kp_variance
        self.num_channels = num_channels
        self.use_deformed_source_image = use_deformed_source_image
        self.use_difference = use_difference
        self.use_heatmap = use_heatmap
        self.add_bg_feature_map = add_bg_feature_map
        self.heatmap_type = heatmap_type
        self.norm_const = norm_const
        self.scale_factor = scale_factor

    @property
    def out_channels(self) -> int:
        per_kp = (
            int(self.use_heatmap)
            + 2 * int(self.use_difference)
            + self.num_channels * int(self.use_deformed_source_image)
        )
        return per_kp * (self.num_kp + int(self.add_bg_feature_map))

    def forward(self, source_image, kp_driving, kp_source):
        """source_image (B, 1, H, W, C); kp dicts with mean (B, D, K, 2).
        Returns (B, D, h, w, out_channels) in the source's dtype."""
        if self.scale_factor != 1:
            H, W = source_image.shape[-3], source_image.shape[-2]
            source_image = resize_nearest(
                source_image,
                (int(H * self.scale_factor), int(W * self.scale_factor)),
            )
        B, T, h, w, C = source_image.shape
        D = kp_driving["mean"].shape[1]
        Kb = self.num_kp + int(self.add_bg_feature_map)
        feat_dtype = source_image.dtype
        parts = []  # each (B, D, h, w, Kb, c_i)

        if self.use_heatmap:
            render_heatmap = heatmap_plain if self.training else heatmap_kernel

            def render(kp):
                return render_heatmap(kp, (h, w), self.kp_variance, self.norm_const)

            heat = render(kp_driving)  # (B, D, K, h, w) f32
            if self.heatmap_type == "difference":
                heat = heat - render(kp_source)
            if self.add_bg_feature_map:
                heat = torch.cat([torch.zeros_like(heat[:, :, :1]), heat], dim=2)
            heat = heat.to(feat_dtype)
            parts.append(heat.permute(0, 1, 3, 4, 2)[..., None])

        if self.use_difference or self.use_deformed_source_image:
            kp_diff = kp_source["mean"] - kp_driving["mean"]  # (B, D, K, 2)
            if self.add_bg_feature_map:
                kp_diff = torch.cat([torch.zeros_like(kp_diff[:, :, :1]), kp_diff], dim=2)

        if self.use_difference:
            parts.append(
                kp_diff.to(feat_dtype)[:, :, None, None].expand(B, D, h, w, Kb, 2)
            )

        if self.use_deformed_source_image:
            src = source_image.permute(0, 2, 3, 1, 4).reshape(B, h, w, T * C)
            deformed = shift_sample(src, kp_diff.reshape(B, D * Kb, 2))
            deformed = deformed.reshape(B, D, Kb, h, w, T * C)
            parts.append(deformed.permute(0, 1, 3, 4, 2, 5))

        out = torch.cat(parts, dim=-1)
        return out.reshape(B, D, h, w, -1)
