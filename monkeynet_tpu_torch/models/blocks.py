"""NN building blocks on channels-last (B, D, H, W, C) videos.

Counterpart of monkeynet_tpu/models/blocks.py. Every conv on the forward
path has a depth-1 kernel, so D folds into the batch and the conv runs as a
2-D conv on a channels_last view: (B*D, H, W, C) permuted to NCHW shape
with NHWC strides, which cuDNN takes without a copy.

Parameter names and layouts are the reference's state_dict: conv weights are
5-D (out, in/groups, 1, kh, kw); batch norms hold weight, bias,
running_mean, running_var and num_batches_tracked; blocks are
`down_blocks.i`, `up_blocks.i`, and so on. A published checkpoint loads
with plain `load_state_dict`.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from monkeynet_tpu_torch.ops.sampling import resize_nearest
from monkeynet_tpu_torch.parallel.distributed import all_reduce_sum


class Conv3D(nn.Module):
    """Conv over (B, D, H, W, C) with a depth-1 kernel and torch's default
    init, U(+-1/sqrt(fan_in)) for weight and bias. `groups` is torch's
    grouped convolution (the JAX package's block-diagonal conv)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size=(1, 3, 3), padding=(0, 1, 1), groups: int = 1):
        super().__init__()
        kt, kh, kw = kernel_size
        if kt != 1 or padding[0] != 0:
            raise NotImplementedError("only depth-1 kernels are ported")
        if in_features % groups or out_features % groups:
            raise ValueError(
                f"grouped conv: in_features {in_features} and out_features "
                f"{out_features} must both be divisible by groups {groups}"
            )
        self.padding = (padding[1], padding[2])
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features // groups, kt, kh, kw)
        )
        self.bias = nn.Parameter(torch.empty(out_features))
        # Set by owners that need another init (the dense-motion head).
        self.zero_weight = False
        self.bias_values: Optional[Sequence[float]] = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            if self.zero_weight:
                self.weight.zero_()
            else:
                self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias_values is not None:
                self.bias.copy_(torch.tensor(self.bias_values, dtype=self.bias.dtype))
            else:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        B, D, H, W, C = x.shape
        y = F.conv2d(
            x.reshape(B * D, H, W, C).permute(0, 3, 1, 2),
            self.weight[:, :, 0],
            self.bias,
            padding=self.padding,
            groups=self.groups,
        )
        y = y.permute(0, 2, 3, 1)
        return y.reshape(B, D, y.shape[1], y.shape[2], y.shape[3])


class SyncBatchNorm(nn.Module):
    """Batch norm over the channel (last) axis.

    Eval normalises with the running statistics. Train mode computes the
    batch's statistics in f32 (biased variance to normalise, unbiased for the
    running estimate, torch momentum), and gradients flow through the batch
    mean and variance as in the JAX package. With a process `group` (set by
    `set_process_group`) the statistics are the global batch's: the sum,
    the sum of squares and the count are summed over the group in one
    differentiable all-reduce (the JAX package's psum over its axis), so
    the running variance is unbiased with the global count and the backward
    sums the statistics' cotangents over the ranks.

    `update_running_stats` False (see `frozen_running_stats`) normalises
    with the batch's statistics as in training but leaves the running ones
    alone: the recompute of a rematerialised forward must not update them a
    second time.
    """

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.update_running_stats = True
        self.group = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float().reshape(-1, x.shape[-1])
            s, ss = xf.sum(dim=0), (xf * xf).sum(dim=0)
            cnt = xf.new_full((), float(xf.shape[0]))
            if self.group is not None:
                c = s.shape[0]
                stats = all_reduce_sum(torch.cat([s, ss, cnt[None]]), self.group)
                s, ss, cnt = stats[:c], stats[c:2 * c], stats[2 * c]
            mean = s / cnt
            var = torch.clamp(ss / cnt - mean * mean, min=0.0)
            if self.update_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * (cnt / torch.clamp(cnt - 1.0, min=1.0))
                    self.running_mean.mul_(1.0 - m).add_(m * mean.to(self.running_mean.dtype))
                    self.running_var.mul_(1.0 - m).add_(m * unbiased.to(self.running_var.dtype))
                    self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean.to(x.dtype)) * (inv * self.weight).to(x.dtype) + self.bias.to(x.dtype)


def set_process_group(module: nn.Module, group) -> nn.Module:
    """Reduce the training statistics of every SyncBatchNorm of `module`
    over `group` (None: this process's batch alone). Returns `module`."""
    for m in module.modules():
        if isinstance(m, SyncBatchNorm):
            m.group = group
    return module


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, the SyncBatchNorms of `module` leave their running
    statistics alone (they still normalise with the batch's in training)."""
    norms = [m for m in module.modules() if isinstance(m, SyncBatchNorm)]
    saved = [m.update_running_stats for m in norms]
    for m in norms:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, saved):
            m.update_running_stats = flag


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over (D, H, W) of a
    (B, D, H, W, C) video, affine: biased variance, eps 1e-5, no running
    statistics, computed in the input's dtype (InstanceNorm3d(affine=True)
    as the discriminator uses it)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        centred = x - mean
        var = (centred * centred).mean(dim=(1, 2, 3), keepdim=True)
        return centred * torch.rsqrt(var + self.eps) * self.weight + self.bias


def avg_pool_2x2(x):
    """(1, 2, 2) average pooling of (B, D, H, W, C), floor mode: a trailing
    odd row or column is dropped."""
    B, D, H, W, C = x.shape
    H2, W2 = H // 2, W // 2
    x = x[:, :, : 2 * H2, : 2 * W2]
    return x.reshape(B, D, H2, 2, W2, 2, C).mean(dim=(3, 5))


class DownBlock(nn.Module):
    """conv -> BN -> relu -> (1, 2, 2) avg-pool (encoder step)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = Conv3D(in_features, out_features)
        self.norm = SyncBatchNorm(out_features)

    def forward(self, x):
        return avg_pool_2x2(F.relu(self.norm(self.conv(x))))


class UpBlock(nn.Module):
    """Nearest 2x upsample -> conv3x3 -> BN -> relu (decoder step). The JAX
    package fuses the upsample into the conv; the math is the same."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = Conv3D(in_features, out_features)
        self.norm = SyncBatchNorm(out_features)

    def forward(self, x):
        H, W = x.shape[-3], x.shape[-2]
        x = resize_nearest(x, (2 * H, 2 * W))
        return F.relu(self.norm(self.conv(x)))


class SameBlock(nn.Module):
    """(grouped) conv -> BN -> relu, resolution-preserving."""

    def __init__(self, in_features: int, out_features: int, groups: int = 1,
                 kernel_size=(1, 3, 3), padding=(0, 1, 1)):
        super().__init__()
        self.conv = Conv3D(in_features, out_features, kernel_size, padding, groups)
        self.norm = SyncBatchNorm(out_features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class ResBlock(nn.Module):
    """Pre-activation residual block: (BN-relu-conv) x2 + skip."""

    def __init__(self, features: int):
        super().__init__()
        self.norm1 = SyncBatchNorm(features)
        self.conv1 = Conv3D(features, features)
        self.norm2 = SyncBatchNorm(features)
        self.conv2 = Conv3D(features, features)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return out + x


def hourglass_channels(block_expansion: int, num_blocks: int, max_features: int):
    """Channels at scale i (after i+1 downsamples)."""
    return [
        min(max_features, block_expansion * (2 ** (i + 1))) for i in range(num_blocks)
    ]


class Encoder(nn.Module):
    """Stack of DownBlocks; returns every map [x, f1, ..., fn]."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256):
        super().__init__()
        chans = hourglass_channels(block_expansion, num_blocks, max_features)
        ins = [in_features] + chans[:-1]
        self.down_blocks = nn.ModuleList(
            DownBlock(i, o) for i, o in zip(ins, chans)
        )

    def forward(self, x) -> List[torch.Tensor]:
        outs = [x]
        for block in self.down_blocks:
            outs.append(block(outs[-1]))
        return outs


class Decoder(nn.Module):
    """U-Net decoder over the Encoder's skip list.

    `additional_features` is the width of the maps the caller has already
    concatenated onto every skip, the bottleneck included (the generator's
    kp embedding). With use_last_conv=False it returns the final concat
    (`out_channels` wide) for an external head.
    """

    def __init__(self, block_expansion: int, in_features: int, out_features: int = 3,
                 num_blocks: int = 3, max_features: int = 256,
                 additional_features: int = 0, use_last_conv: bool = True):
        super().__init__()
        blocks = []
        for i in range(num_blocks - 1, -1, -1):
            mult = 1 if i == num_blocks - 1 else 2
            in_filters = mult * min(max_features, block_expansion * (2 ** (i + 1)))
            out_filters = min(max_features, block_expansion * (2**i))
            blocks.append(UpBlock(in_filters + additional_features, out_filters))
        self.up_blocks = nn.ModuleList(blocks)
        self.out_channels = block_expansion + in_features + additional_features
        if use_last_conv:
            self.conv = Conv3D(self.out_channels, out_features)
        else:
            self.conv = None

    def forward(self, skips: Sequence[torch.Tensor]):
        skips = list(skips)
        out = skips.pop()
        for block in self.up_blocks:
            out = torch.cat([block(out), skips.pop()], dim=-1)
        if self.conv is not None:
            out = self.conv(out)
        return out


class Hourglass(nn.Module):
    """Encoder followed by Decoder (keypoint / dense-motion predictor body)."""

    def __init__(self, block_expansion: int, in_features: int, out_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks, max_features)
        self.decoder = Decoder(
            block_expansion, in_features, out_features, num_blocks, max_features
        )

    def forward(self, x):
        return self.decoder(self.encoder(x))


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every block of `model` from `generator`, in module order."""
    for module in model.modules():
        if isinstance(module, (Conv3D, SyncBatchNorm, InstanceNorm)):
            module.reset_parameters(generator)
    return model
