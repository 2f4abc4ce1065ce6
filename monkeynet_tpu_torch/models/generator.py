"""Motion-transfer generator: source frame + kp pair -> animated frames.

Counterpart of monkeynet_tpu/models/generator.py: appearance encoder over
the source frame; dense backward flow from the dense-motion module; every
encoder skip warped by the (resized) flow, the first of them, the source
frame itself, also returned as video_deformed (the JAX package warps the
source frame a second time for it); the kp
embedding concatenated onto every skip, each skip carried at a multiple of
8 channels (blocks.carried); U-Net decode; ResBlock refinement at the
decoder's carried width; sigmoid. All driving frames go through as one batch (D folds into the conv
batch). On CUDA the warps run in the warp kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from monkeynet_tpu_torch.models.blocks import Conv3D, Decoder, Encoder, ResBlock, cat_carried
from monkeynet_tpu_torch.models.dense_motion import DenseMotion, identity_deformation
from monkeynet_tpu_torch.models.movement_embedding import MovementEmbedding
from monkeynet_tpu_torch.ops.sampling import resize_video, warp_video


class MotionTransferGenerator(nn.Module):
    def __init__(self, num_channels: int, num_kp: int, kp_variance: Union[str, float],
                 block_expansion: int, max_features: int, num_blocks: int,
                 num_refinement_blocks: int,
                 dense_motion_params: Optional[Dict[str, Any]] = None,
                 kp_embedding_params: Optional[Dict[str, Any]] = None,
                 interpolation_mode: str = "nearest"):
        super().__init__()
        self.interpolation_mode = interpolation_mode
        self.appearance_encoder = Encoder(
            block_expansion, num_channels, num_blocks, max_features
        )
        self.dense_motion_module = None
        if dense_motion_params is not None:
            self.dense_motion_module = DenseMotion(
                num_kp=num_kp, num_channels=num_channels, kp_variance=kp_variance,
                **dense_motion_params,
            )
        self.kp_embedding_module = None
        embedding_features = 0
        if kp_embedding_params is not None:
            self.kp_embedding_module = MovementEmbedding(
                num_kp=num_kp, kp_variance=kp_variance, num_channels=num_channels,
                **kp_embedding_params,
            )
            embedding_features = self.kp_embedding_module.out_channels
        self.video_decoder = Decoder(
            block_expansion, num_channels, num_channels, num_blocks, max_features,
            additional_features=embedding_features, use_last_conv=False,
        )
        features = self.video_decoder.out_channels
        width = self.video_decoder.out_carried
        self.refinement_module = nn.Sequential()
        for i in range(num_refinement_blocks):
            self.refinement_module.add_module(f"r{i}", ResBlock(features, width))
        self.refinement_module.add_module(
            "conv-last",
            Conv3D(features, num_channels, (1, 1, 1), (0, 0, 0), carried_in=width),
        )

    def _deform_input(self, inp, deformation):
        """Warp (B, 1, h, w, C) by the flow (B, D, hf, wf, 2), resized to the
        input's size first."""
        h, w = inp.shape[2], inp.shape[3]
        flow = resize_video(deformation, (h, w), mode=self.interpolation_mode)
        return warp_video(inp[:, 0], flow)

    def forward(self, source_image, kp_driving, kp_source):
        """source_image (B, 1, H, W, C); kp dicts (B, D, K, ...).
        Returns {'video_prediction', 'video_deformed'}: (B, D, H, W, C)."""
        appearance_skips = self.appearance_encoder(source_image)
        if self.dense_motion_module is not None:
            deformation = self.dense_motion_module(source_image, kp_driving, kp_source)
        else:
            deformation = identity_deformation(source_image, kp_driving)

        skips = [self._deform_input(skip, deformation) for skip in appearance_skips]
        # The encoder's first skip is the source frame itself (Encoder.forward),
        # so its warp is video_deformed: one warp fewer than the JAX package
        # launches, with the same values.
        video_deformed = skips[0]
        if self.kp_embedding_module is not None:
            embedding = self.kp_embedding_module(source_image, kp_driving, kp_source)
            skips = [
                cat_carried(
                    [skip, resize_video(embedding, (skip.shape[2], skip.shape[3]),
                                        mode=self.interpolation_mode)],
                    width,
                )
                for skip, width in zip(skips, self.video_decoder.skip_widths)
            ]
        out = self.refinement_module(self.video_decoder(skips))
        return {
            "video_prediction": torch.sigmoid(out),
            "video_deformed": video_deformed,
        }
