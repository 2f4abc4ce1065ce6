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

Carried widths. cuDNN's NHWC tensor-core convolutions take a channel count
aligned to 8 (bf16; 4 in f32) and copy any other input into a padded buffer
before every call. So every activation the networks build themselves and
feed to a conv (a concat, the refinement chain, the dense motion's grouped
output) is carried at `carried(width)` channels, the channels past the
reference's width zeros at the end. A conv that takes such an input gets
zero weight columns there, and one that emits it zero weight rows and zero
bias; a batch norm over it scale 0 and shift 0, so the zero channels stay
exactly 0 in eval and in training. The padded weights are derived from the
parameters at the call (`_carry`), never stored: parameters, buffers and
state_dict keep the reference's shapes. Which activations are carried
follows from the widths a module is built with alone.

Eval batch norms. In eval a batch norm is a per-channel affine, x * scale +
shift (`SyncBatchNorm.affine`, computed in f32). Where the affine is kept
(`_keeps`: eval, no autograd, no CUDA-graph capture), a norm that reads a
conv's output and nothing else (`Conv3D(x, norm)`) runs folded into that
conv: weight rows times scale, bias (b - mean) * scale + beta, no pass of
its own; a norm with no conv before it (`ResBlock.norm1`, after the
residual sum) runs as one multiply-add. Training, remat's recompute and a
captured step compute the norm as the reference does.
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

ALIGN = 8


def carried(features: int) -> int:
    """The width at which the networks carry an activation of `features`
    channels that they build themselves: a multiple of ALIGN."""
    return -(-features // ALIGN) * ALIGN


def cat_carried(parts: Sequence[torch.Tensor], width: int) -> torch.Tensor:
    """torch.cat of `parts` on the channel (last) axis, with zero channels
    appended up to `width` in the same cat."""
    pad = width - sum(p.shape[-1] for p in parts)
    if pad:
        last = parts[-1]
        parts = [*parts, last.new_zeros(()).expand(*last.shape[:-1], pad)]
    return torch.cat(parts, dim=-1)


def _keeps(module: nn.Module, t: torch.Tensor) -> bool:
    """Whether tensors made from `module`'s parameters (on `t`'s device) may
    be kept between calls: in eval, without autograd, outside a CUDA-graph
    capture."""
    return not (module.training or torch.is_grad_enabled()
                or (t.is_cuda and torch.cuda.is_current_stream_capturing()))


def _carry(module: nn.Module, sources: Sequence[torch.Tensor], make,
           slot: str = "_carry", tag=None):
    """make(): tensors derived from the module's `sources`, such as its
    padded weights. Made at the call where autograd or a CUDA-graph capture
    may see them (a training forward pads inside the graph, and autograd
    slices the gradient back); where `_keeps`, made once and kept in `slot`
    until one of `sources` changes in place or is replaced (its storage or
    version), `tag` (a dtype) changes, or the module is moved or cast
    (`_apply`)."""
    if not _keeps(module, sources[0]):
        return make()
    key = (tag, *((t.data_ptr(), t._version) for t in sources))
    if getattr(module, slot + "_key") != key:
        setattr(module, slot, make())
        setattr(module, slot + "_key", key)
    return getattr(module, slot)


class _Carrying(nn.Module):
    """A module whose derived tensors `_carry` keeps between eval calls: its
    padded tensors (`_carry`) and a conv's folded weights (`_fold`)."""

    def __init__(self):
        super().__init__()
        self._forget()

    def _forget(self):
        self._carry = self._carry_key = self._fold = self._fold_key = None

    def _apply(self, fn, recurse=True):
        self._forget()
        return super()._apply(fn, recurse)


class Conv3D(_Carrying):
    """Conv over (B, D, H, W, C) with a depth-1 kernel and torch's default
    init, U(+-1/sqrt(fan_in)) for weight and bias. `groups` is torch's
    grouped convolution (the JAX package's block-diagonal conv).

    `carried_in` is the width of the input as it arrives (`in_features`
    channels, then zeros), `carried_out` the width of the output (zeros past
    `out_features`); both default to the reference's widths."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size=(1, 3, 3), padding=(0, 1, 1), groups: int = 1,
                 carried_in: Optional[int] = None, carried_out: Optional[int] = None):
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
        self.carried_in = carried_in or in_features
        self.carried_out = carried_out or out_features
        self._pad = (self.carried_in - in_features, self.carried_out - out_features)
        if groups != 1 and self._pad != (0, 0):
            raise ValueError("a grouped conv keeps the reference's widths")
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

    def _padded(self):
        pad_in, pad_out = self._pad
        weight = F.pad(self.weight, (0, 0, 0, 0, 0, 0, 0, pad_in, 0, pad_out))
        return weight, (F.pad(self.bias, (0, pad_out)) if pad_out else self.bias)

    def _folded(self, norm: "SyncBatchNorm"):
        """The padded weight and bias with `norm`'s eval affine folded in:
        each output row times its scale, the bias (b - mean) * scale + beta;
        computed in f32, kept in the parameters' dtype."""
        scale, shift = norm.affine()
        weight, bias = self._padded()
        return ((weight.float() * scale[:, None, None, None, None]).to(weight.dtype),
                (bias.float() * scale + shift).to(bias.dtype))

    def forward(self, x, norm: Optional["SyncBatchNorm"] = None):
        """The conv of `x`; with `norm`, norm(conv(x)), where nothing else
        reads the conv's output: folded into the conv's weight and bias
        where the eval affine is kept (`_keeps`)."""
        B, D, H, W, C = x.shape
        weight, bias = self.weight, self.bias
        fold = norm is not None and not norm.training and _keeps(self, weight)
        if fold:
            weight, bias = _carry(self, (weight, bias, *norm.statistics()),
                                  lambda: self._folded(norm), "_fold")
        elif self._pad != (0, 0):
            weight, bias = _carry(self, (weight, bias), self._padded)
        y = F.conv2d(
            x.reshape(B * D, H, W, C).permute(0, 3, 1, 2),
            weight[:, :, 0],
            bias,
            padding=self.padding,
            groups=self.groups,
        )
        y = y.permute(0, 2, 3, 1)
        y = y.reshape(B, D, y.shape[1], y.shape[2], y.shape[3])
        return y if norm is None or fold else norm(y)


class SyncBatchNorm(_Carrying):
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

    `carried` is the width of the input (`features` channels, then zeros):
    the zero channels get scale 0 and shift 0 (mean 0 and variance 1 in
    eval), so they leave as zeros; their batch statistics are 0 and stay
    out of the running ones.
    """

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 carried: Optional[int] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.features = features
        self.carried = carried or features
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

    def statistics(self):
        """The tensors the eval affine is made from."""
        return self.weight, self.bias, self.running_mean, self.running_var

    def affine(self):
        """The eval norm as x * scale + shift: (scale, shift) in f32 at the
        carried width, zeros past `features`."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        pad = (0, self.carried - self.features)
        return F.pad(scale, pad), F.pad(shift, pad)

    def _padded(self):
        pad = (0, self.carried - self.features)
        weight, bias = F.pad(self.weight, pad), F.pad(self.bias, pad)
        if self.training:
            return weight, bias, None, None
        return (weight, bias, F.pad(self.running_mean, pad),
                F.pad(self.running_var, pad, value=1.0))

    def forward(self, x):
        if not self.training and _keeps(self, x):
            scale, shift = _carry(
                self, self.statistics(),
                lambda: tuple(t.to(x.dtype) for t in self.affine()), tag=x.dtype)
            return torch.addcmul(shift, x, scale)
        weight, bias = self.weight, self.bias
        running_mean, running_var = self.running_mean, self.running_var
        if self.carried != self.features:
            weight, bias, running_mean, running_var = self._padded()
        if not self.training:
            mean, var = running_mean, running_var
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
                    m, f = self.momentum, self.features
                    unbiased = var[:f] * (cnt / torch.clamp(cnt - 1.0, min=1.0))
                    self.running_mean.mul_(1.0 - m).add_(m * mean[:f].to(self.running_mean.dtype))
                    self.running_var.mul_(1.0 - m).add_(m * unbiased.to(self.running_var.dtype))
                    self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean.to(x.dtype)) * (inv * weight).to(x.dtype) + bias.to(x.dtype)


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

    def __init__(self, in_features: int, out_features: int,
                 carried_in: Optional[int] = None):
        super().__init__()
        self.conv = Conv3D(in_features, out_features, carried_in=carried_in)
        self.norm = SyncBatchNorm(out_features)

    def forward(self, x):
        return avg_pool_2x2(F.relu(self.conv(x, self.norm)))


class UpBlock(nn.Module):
    """Nearest 2x upsample -> conv3x3 -> BN -> relu (decoder step). The JAX
    package fuses the upsample into the conv; the math is the same."""

    def __init__(self, in_features: int, out_features: int,
                 carried_in: Optional[int] = None):
        super().__init__()
        self.conv = Conv3D(in_features, out_features, carried_in=carried_in)
        self.norm = SyncBatchNorm(out_features)

    def forward(self, x):
        H, W = x.shape[-3], x.shape[-2]
        x = resize_nearest(x, (2 * H, 2 * W))
        return F.relu(self.conv(x, self.norm))


class SameBlock(nn.Module):
    """(grouped) conv -> BN -> relu, resolution-preserving."""

    def __init__(self, in_features: int, out_features: int, groups: int = 1,
                 kernel_size=(1, 3, 3), padding=(0, 1, 1)):
        super().__init__()
        self.conv = Conv3D(in_features, out_features, kernel_size, padding, groups)
        self.norm = SyncBatchNorm(out_features)

    def forward(self, x):
        return F.relu(self.conv(x, self.norm))


class ResBlock(nn.Module):
    """Pre-activation residual block: (BN-relu-conv) x2 + skip, in and out
    at the width `carried` (zeros past `features`). norm2 reads conv1's
    output alone, so it folds into conv1; norm1 reads the residual sum."""

    def __init__(self, features: int, carried: Optional[int] = None):
        super().__init__()
        self.norm1 = SyncBatchNorm(features, carried=carried)
        self.conv1 = Conv3D(features, features, carried_in=carried, carried_out=carried)
        self.norm2 = SyncBatchNorm(features, carried=carried)
        self.conv2 = Conv3D(features, features, carried_in=carried, carried_out=carried)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)), self.norm2)
        out = self.conv2(F.relu(out))
        return out + x


def hourglass_channels(block_expansion: int, num_blocks: int, max_features: int):
    """Channels at scale i (after i+1 downsamples)."""
    return [
        min(max_features, block_expansion * (2 ** (i + 1))) for i in range(num_blocks)
    ]


class Encoder(nn.Module):
    """Stack of DownBlocks; returns every map [x, f1, ..., fn]. The input
    arrives `carried_in` wide."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, carried_in: Optional[int] = None):
        super().__init__()
        chans = hourglass_channels(block_expansion, num_blocks, max_features)
        ins = [in_features] + chans[:-1]
        self.down_blocks = nn.ModuleList(
            DownBlock(i, o, carried_in if n == 0 else None)
            for n, (i, o) in enumerate(zip(ins, chans))
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
    kp embedding), each such skip carried at `skip_widths[i]`; without them
    the input skip arrives `carried_in` wide and the encoder's maps as they
    are. Every concat is carried (`cat_widths`). With use_last_conv=False it
    returns the final concat, `out_channels` wide carried at `out_carried`,
    for an external head.
    """

    def __init__(self, block_expansion: int, in_features: int, out_features: int = 3,
                 num_blocks: int = 3, max_features: int = 256,
                 additional_features: int = 0, use_last_conv: bool = True,
                 carried_in: Optional[int] = None):
        super().__init__()
        widths = [in_features] + hourglass_channels(block_expansion, num_blocks, max_features)
        if additional_features:
            if carried_in not in (None, in_features):
                raise ValueError("a carried input takes no additional features")
            self.skip_widths = [carried(c + additional_features) for c in widths]
        else:
            self.skip_widths = [carried_in or in_features] + widths[1:]
        blocks, self.cat_widths = [], []
        width = self.skip_widths[-1]
        for i in range(num_blocks - 1, -1, -1):
            mult = 1 if i == num_blocks - 1 else 2
            in_filters = mult * min(max_features, block_expansion * (2 ** (i + 1)))
            out_filters = min(max_features, block_expansion * (2**i))
            blocks.append(UpBlock(in_filters + additional_features, out_filters, width))
            width = carried(out_filters + self.skip_widths[i])
            self.cat_widths.append(width)
        self.up_blocks = nn.ModuleList(blocks)
        self.out_channels = block_expansion + in_features + additional_features
        self.out_carried = width
        if use_last_conv:
            self.conv = Conv3D(self.out_channels, out_features, carried_in=width)
        else:
            self.conv = None

    def forward(self, skips: Sequence[torch.Tensor]):
        skips = list(skips)
        out = skips.pop()
        for block, width in zip(self.up_blocks, self.cat_widths):
            out = cat_carried([block(out), skips.pop()], width)
        if self.conv is not None:
            out = self.conv(out)
        return out


class Hourglass(nn.Module):
    """Encoder followed by Decoder (keypoint / dense-motion predictor body),
    its input `carried_in` wide."""

    def __init__(self, block_expansion: int, in_features: int, out_features: int,
                 num_blocks: int = 3, max_features: int = 256,
                 carried_in: Optional[int] = None):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks, max_features,
                               carried_in)
        self.decoder = Decoder(
            block_expansion, in_features, out_features, num_blocks, max_features,
            carried_in=carried_in,
        )

    def forward(self, x):
        return self.decoder(self.encoder(x))


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every block of `model` from `generator`, in module order."""
    for module in model.modules():
        if isinstance(module, (Conv3D, SyncBatchNorm, InstanceNorm)):
            module.reset_parameters(generator)
    return model
