"""Dense motion module: sparse keypoint displacements -> dense backward flow.

Counterpart of monkeynet_tpu/models/dense_motion.py:

  mask embedding -> [grouped 1x1 SameBlocks + leaky_relu] -> hourglass
  -> softmax over the K+1 mask logits
  grid = sum_k mask_k * (kp_source - kp_driving)_k (+ correction) + identity

The last grouped block's leaky-relu writes into the first channels of a
buffer carried at a multiple of 8 channels, zeros past the embedding's
width (a grouped conv cannot emit them), and the hourglass takes it at that
width. The hourglass's final conv starts at zero with bias `bg_init` on the
background logit, so an untrained model is the identity deformation. The
sampling grid is f32 under any network dtype; on CUDA the combine runs in
the combine kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.nn.functional as F
from torch import nn

from monkeynet_tpu_torch.models.blocks import Hourglass, SameBlock, carried
from monkeynet_tpu_torch.models.movement_embedding import MovementEmbedding
from monkeynet_tpu_torch.ops.cuda.combine import combine
from monkeynet_tpu_torch.ops.grid import make_coordinate_grid
from monkeynet_tpu_torch.ops.sampling import resize_nearest


def identity_deformation(source_image, kp_driving):
    """Identity sampling grid (B, D, h, w, 2) in f32, for configs without
    dense motion."""
    B, _, h, w, _ = source_image.shape
    D = kp_driving["mean"].shape[1]
    grid = make_coordinate_grid((h, w), dtype=torch.float32, device=source_image.device)
    return grid[None, None].expand(B, D, h, w, 2)


class _LeakyReluCarried(torch.autograd.Function):
    """leaky_relu(x) written into the first channels of a buffer `width`
    channels wide whose other channels are zeros."""

    @staticmethod
    def forward(ctx, x, slope: float, width: int):
        c = x.shape[-1]
        out = x.new_empty(*x.shape[:-1], width)
        torch.ops.aten.leaky_relu.out(x, slope, out=out[..., :c])
        out[..., c:].zero_()
        ctx.save_for_backward(x)
        ctx.slope = slope
        return out

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        grad_x = torch.ops.aten.leaky_relu_backward(
            grad[..., : x.shape[-1]], x, ctx.slope, False)
        return grad_x, None, None


class DenseMotion(nn.Module):
    def __init__(self, block_expansion: int, num_blocks: int, max_features: int,
                 mask_embedding_params: Dict[str, Any], num_kp: int, num_channels: int,
                 kp_variance: Union[str, float], use_correction: bool, use_mask: bool,
                 bg_init: float = 2.0, num_group_blocks: int = 0,
                 scale_factor: float = 1.0):
        super().__init__()
        self.num_kp = num_kp
        self.use_correction = use_correction
        self.use_mask = use_mask
        self.scale_factor = scale_factor
        self.mask_embedding = MovementEmbedding(
            num_kp=num_kp, kp_variance=kp_variance, num_channels=num_channels,
            add_bg_feature_map=True, **mask_embedding_params,
        )
        ch = self.mask_embedding.out_channels
        self.group_blocks = nn.ModuleList(
            SameBlock(ch, ch, groups=num_kp + 1, kernel_size=(1, 1, 1), padding=(0, 0, 0))
            for _ in range(num_group_blocks)
        )
        num_mask_ch = (num_kp + 1) * int(use_mask)
        out_ch = num_mask_ch + 2 * int(use_correction)
        self.embed_width = carried(ch) if num_group_blocks else ch
        self.hourglass = Hourglass(block_expansion, ch, out_ch, num_blocks, max_features,
                                   self.embed_width)
        head = self.hourglass.decoder.conv
        head.zero_weight = True
        head.bias_values = (
            ([bg_init] + [0.0] * num_kp) * int(use_mask) + [0.0, 0.0] * int(use_correction)
        )

    def forward(self, source_image, kp_driving, kp_source):
        """source_image (B, 1, H, W, C) -> (B, D, h, w, 2) f32 sampling grid."""
        if self.scale_factor != 1:
            H, W = source_image.shape[-3], source_image.shape[-2]
            source_image = resize_nearest(
                source_image,
                (int(H * self.scale_factor), int(W * self.scale_factor)),
            )
        embed = self.mask_embedding(source_image, kp_driving, kp_source)
        for i, block in enumerate(self.group_blocks, 1):
            embed = block(embed)
            if i == len(self.group_blocks) and self.embed_width > embed.shape[-1]:
                embed = _LeakyReluCarried.apply(embed, 0.2, self.embed_width)
            else:
                embed = F.leaky_relu(embed, 0.2)
        prediction = self.hourglass(embed)
        B, D, h, w, _ = prediction.shape

        if self.use_mask:
            # The per-kp difference fields are constant over the plane, so
            # the combine is softmax(masks) times a (K+1, 2) table per frame.
            kp_diff = (kp_source["mean"] - kp_driving["mean"]).float()
            kp_diff = torch.cat([torch.zeros_like(kp_diff[:, :, :1]), kp_diff], dim=2)
            logits = prediction[..., : self.num_kp + 1].float().contiguous()
            if self.use_correction:
                corr = prediction[..., -2:].float().contiguous()
            else:
                corr = torch.zeros((B, D, h, w, 2), dtype=torch.float32,
                                   device=prediction.device)
            return combine(logits, kp_diff.contiguous(), corr)

        relative = torch.zeros((B, D, h, w, 2), dtype=torch.float32, device=prediction.device)
        if self.use_correction:
            relative = relative + prediction[..., -2:].float()
        grid = make_coordinate_grid((h, w), dtype=torch.float32, device=prediction.device)
        return relative + grid[None, None]
