"""Seeded frames, made on the device in a few large calls.

There are no Tai-Chi or VoxCeleb frames in the repository, so the benchmark
draws its own: clips of smooth colour fields that drift over time. Each clip
holds random low-resolution key fields, one every `key_every` frames, blended
linearly in time and upsampled bilinearly to the frame size, then squashed to
[0, 1]. Frames of one clip are related as a video's are, so keypoints move
from frame to frame and a driving video has motion to transfer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clips(n_clips: int, clip_len: int, hw, seed: int, device, key_every: int = 8,
          key_hw: int = 6) -> torch.Tensor:
    """(n_clips, clip_len, H, W, 3) float32 frames in [0, 1] on `device`."""
    H, W = hw
    gen = torch.Generator(device=device).manual_seed(seed)
    n_keys = clip_len // key_every + 2
    keys = torch.randn((n_clips, n_keys, 3, key_hw, key_hw), generator=gen, device=device)
    t = torch.arange(clip_len, device=device, dtype=torch.float32) / key_every
    lo = t.floor().long()
    w = (t - lo)[None, :, None, None, None]
    fields = keys[:, lo] * (1.0 - w) + keys[:, lo + 1] * w  # (n, L, 3, kh, kw)
    frames = F.interpolate(fields.reshape(n_clips * clip_len, 3, key_hw, key_hw), size=(H, W),
                           mode="bicubic", align_corners=False)
    frames = torch.sigmoid(1.5 * frames)
    return frames.permute(0, 2, 3, 1).reshape(n_clips, clip_len, H, W, 3).contiguous()


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    return (frames * 255.0).round_().clamp_(0, 255).to(torch.uint8)
