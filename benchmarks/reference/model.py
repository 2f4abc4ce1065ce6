"""Monkey-Net in plain PyTorch: the benchmark's frozen reference.

Written for the benchmark from the published model (Siarohin et al.,
"Animating Arbitrary Objects via Deep Motion Transfer", CVPR 2019, and its
code's config/*.yaml). It imports nothing of the program under test. Its
state_dict names and layouts are the published checkpoint's, which the
program keeps too, so one set of seeded tensors loads into both.

Videos are channels-last (B, D, H, W, C); every conv has a depth-1 kernel, so
frames fold into the conv batch. Warps are `F.grid_sample` (bilinear,
zeros padding, align_corners=True); the shifted source copies of the
movement embedding are `F.grid_sample` at the identity grid plus the
keypoint difference; the soft-argmax and the gaussians are sums over the
plane. Keypoint math, the mask softmax and sampling grids are float32.

`Ctx.precision` says how the networks compute: 'f32' (TF32 is switched off
by the caller) or 'fp8', where every layer's tensors (each conv's input, weight
and output, each norm's, warp's and embedding's output, the prediction) are
rounded to float8 e4m3 with a per-tensor scale, and keypoint math, the mask
softmax and the grids stay float32 as the configuration keeps them: the
benchmark's control. 'bf16' rounds the same tensors to bfloat16 instead, the
configuration's own precision: a witness of what rounding alone reads. The
gradient passes each rounding unchanged.

`Recorder` notes, per call of a sampling or keypoint op, the op and its
shapes, so that the benchmark can count the bytes each of the program's
kernels needs (benchmarks/kernels.py) from a run on the `meta` device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Recorder:
    """Collects (op, shapes) of the sampling and keypoint ops a forward
    makes."""

    def __init__(self):
        self.ops: List[tuple] = []

    def add(self, op: str, **shapes):
        self.ops.append((op, shapes))


class _Fp8Round(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = FP8_MAX / amax
        return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _Bf16Round(torch.autograd.Function):
    """Round to bfloat16; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Ctx:
    """What every module of one reference model shares."""

    def __init__(self, precision: str = "f32", recorder: Optional[Recorder] = None):
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.recorder = recorder

    def record(self, op, **shapes):
        if self.recorder is not None:
            self.recorder.add(op, **shapes)

    def q(self, x):
        """x as the precision keeps a layer's tensors."""
        if self.precision == "fp8":
            return _Fp8Round.apply(x)
        return _Bf16Round.apply(x) if self.precision == "bf16" else x


# ----------------------------------------------------------------- primitives


def coordinate_grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) xy grid over [-1, 1]^2."""
    x = torch.linspace(-1.0, 1.0, w, device=device) if w > 1 else torch.zeros(1, device=device)
    y = torch.linspace(-1.0, 1.0, h, device=device) if h > 1 else torch.zeros(1, device=device)
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def resize_nearest(x, hw):
    """Legacy nearest resize of (..., H, W, C): src = floor(dst * in / out)."""
    H, W = x.shape[-3], x.shape[-2]
    if (H, W) == tuple(hw):
        return x
    rows = (torch.arange(hw[0], device=x.device) * H) // hw[0]
    cols = (torch.arange(hw[1], device=x.device) * W) // hw[1]
    return x.index_select(-3, rows).index_select(-2, cols)


def resize_bilinear(x, hw):
    """Half-pixel bilinear resize of (B, D, H, W, C) (F.interpolate's
    'bilinear', align_corners=False, as 'trilinear' does with D unchanged)."""
    B, D, H, W, C = x.shape
    if (H, W) == tuple(hw):
        return x
    y = F.interpolate(x.reshape(B * D, H, W, C).permute(0, 3, 1, 2), size=tuple(hw),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(B, D, hw[0], hw[1], C)


def resize(x, hw, mode):
    return resize_nearest(x, hw) if mode == "nearest" else resize_bilinear(x, hw)


def avg_pool(x):
    B, D, H, W, C = x.shape
    x = x[:, :, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, D, H // 2, 2, W // 2, 2, C).mean(dim=(3, 5))


def kp2gaussian(kp, h, w):
    """(B, D, K, h, w) f32 gaussians of 'matrix' keypoints, peak 1:
    exp(-d^T var^-1 d / 2) with the 2x2 inverse in closed form."""
    mean, var = kp["mean"].float(), kp["var"].float()
    grid = coordinate_grid(h, w, mean.device)
    dx = grid[None, None, None, :, :, 0] - mean[:, :, :, None, None, 0]
    dy = grid[None, None, None, :, :, 1] - mean[:, :, :, None, None, 1]
    a, b, c, d = (var[..., i, j][:, :, :, None, None] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    q = (d * dx * dx - (b + c) * dx * dy + a * dy * dy) / (a * d - b * c)
    return torch.exp(-0.5 * q)


def softargmax(logits, temperature, clip_variance):
    """(B, D, H, W, K) logits -> {'mean' (B,D,K,2), 'var' (B,D,K,2,2)}, f32:
    spatial softmax, +1e-7, then the mean and covariance as sums."""
    B, D, H, W, K = logits.shape
    p = torch.softmax(logits.float().reshape(B, D, H * W, K) / temperature, dim=2)
    p = p.reshape(B, D, H, W, K, 1) + 1e-7
    grid = coordinate_grid(H, W, logits.device)[None, None, :, :, None, :]  # (1,1,H,W,1,2)
    mean = (p * grid).sum(dim=(2, 3))  # (B, D, K, 2)
    d = grid - mean[:, :, None, None]
    var = (p[..., None] * d[..., :, None] * d[..., None, :]).sum(dim=(2, 3))
    if clip_variance:
        a, b, c, e = var[..., 0, 0], var[..., 0, 1], var[..., 1, 0], var[..., 1, 1]
        s1 = a * a + b * b + c * c + e * e
        s2 = torch.sqrt((a * a + b * b - c * c - e * e) ** 2 + 4.0 * (a * c + b * e) ** 2)
        smallest = torch.sqrt((s1 - s2) / 2.0)[..., None, None]
        var = torch.clamp(smallest, min=clip_variance) * var / smallest
    return {"mean": mean, "var": var}


def warp(ctx: Ctx, source, grid):
    """source (B, H, W, C) sampled at grid (B, D, Ho, Wo, 2) -> (B, D, Ho, Wo, C)."""
    B, H, W, C = source.shape
    _, D, Ho, Wo, _ = grid.shape
    ctx.record("warp", B=B, H=H, W=W, C=C, N=D * Ho * Wo,
               source_grad=bool(source.requires_grad))
    out = F.grid_sample(source.permute(0, 3, 1, 2), grid.reshape(B, D * Ho, Wo, 2).to(source.dtype),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return ctx.q(out.permute(0, 2, 3, 1).reshape(B, D, Ho, Wo, C))


# -------------------------------------------------------------------- modules


class Conv(nn.Module):
    """Depth-1 conv with the published 5-D weight (out, in/groups, 1, kh, kw)."""

    def __init__(self, ctx: Ctx, cin, cout, k=3, pad=1, groups=1):
        super().__init__()
        self.ctx, self.pad, self.groups = ctx, pad, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 1, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        B, D, H, W, C = x.shape
        w = self.weight[:, :, 0]
        inp = x.reshape(B * D, H, W, C).permute(0, 3, 1, 2)
        q = self.ctx.q
        y = q(F.conv2d(q(inp), q(w), self.bias, padding=self.pad, groups=self.groups))
        y = y.permute(0, 2, 3, 1)
        return y.reshape(B, D, y.shape[1], y.shape[2], y.shape[3])


class BatchNorm(nn.Module):
    """Batch norm over the channel axis: the batch's statistics in training
    (biased variance), the running ones in eval. `calibrate` True makes a
    training-mode forward set the running statistics to the batch's (the
    benchmark's weight draw)."""

    def __init__(self, ctx, features):
        super().__init__()
        self.ctx = ctx
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.calibrate = False

    def forward(self, x):
        if self.training:
            xf = x.float().reshape(-1, x.shape[-1])
            mean = xf.mean(dim=0)
            var = xf.var(dim=0, unbiased=False)
            if self.calibrate:
                with torch.no_grad():
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
        else:
            mean, var = self.running_mean, self.running_var
        return self.ctx.q((x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias)


class InstanceNorm(nn.Module):
    def __init__(self, ctx, features):
        super().__init__()
        self.ctx = ctx
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        return self.ctx.q((x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias)


class ConvNorm(nn.Module):
    def __init__(self, ctx, cin, cout, k=3, pad=1, groups=1):
        super().__init__()
        self.conv = Conv(ctx, cin, cout, k, pad, groups)
        self.norm = BatchNorm(ctx, cout)


class DownBlock(ConvNorm):
    def forward(self, x):
        return avg_pool(F.relu(self.norm(self.conv(x))))


class UpBlock(ConvNorm):
    def forward(self, x):
        x = resize_nearest(x, (2 * x.shape[2], 2 * x.shape[3]))
        return F.relu(self.norm(self.conv(x)))


class SameBlock(ConvNorm):
    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class ResBlock(nn.Module):
    def __init__(self, ctx, features):
        super().__init__()
        self.norm1 = BatchNorm(ctx, features)
        self.conv1 = Conv(ctx, features, features)
        self.norm2 = BatchNorm(ctx, features)
        self.conv2 = Conv(ctx, features, features)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(out))) + x


def _widths(expansion, blocks, max_features):
    return [min(max_features, expansion * 2 ** (i + 1)) for i in range(blocks)]


class Encoder(nn.Module):
    def __init__(self, ctx, expansion, cin, blocks, max_features):
        super().__init__()
        chans = _widths(expansion, blocks, max_features)
        self.down_blocks = nn.ModuleList(
            DownBlock(ctx, i, o) for i, o in zip([cin] + chans[:-1], chans))

    def forward(self, x):
        outs = [x]
        for block in self.down_blocks:
            outs.append(block(outs[-1]))
        return outs


class Decoder(nn.Module):
    def __init__(self, ctx, expansion, cin, cout, blocks, max_features, extra=0, last=True):
        super().__init__()
        ups = []
        for i in range(blocks - 1, -1, -1):
            mult = 1 if i == blocks - 1 else 2
            fin = mult * min(max_features, expansion * 2 ** (i + 1))
            ups.append(UpBlock(ctx, fin + extra, min(max_features, expansion * 2 ** i)))
        self.up_blocks = nn.ModuleList(ups)
        self.out_channels = expansion + cin + extra
        self.conv = Conv(ctx, self.out_channels, cout) if last else None

    def forward(self, skips):
        skips = list(skips)
        out = skips.pop()
        for block in self.up_blocks:
            out = torch.cat([block(out), skips.pop()], dim=-1)
        return self.conv(out) if self.conv is not None else out


class Hourglass(nn.Module):
    def __init__(self, ctx, expansion, cin, cout, blocks, max_features):
        super().__init__()
        self.encoder = Encoder(ctx, expansion, cin, blocks, max_features)
        self.decoder = Decoder(ctx, expansion, cin, cout, blocks, max_features)

    def forward(self, x):
        return self.decoder(self.encoder(x))


class KPDetector(nn.Module):
    def __init__(self, ctx, block_expansion, num_kp, num_channels, max_features, num_blocks,
                 temperature, kp_variance, scale_factor=1.0, clip_variance=None):
        super().__init__()
        if kp_variance != "matrix":
            raise NotImplementedError("the reference covers kp_variance 'matrix'")
        self.ctx, self.temperature = ctx, temperature
        self.scale_factor, self.clip_variance = scale_factor, clip_variance
        self.predictor = Hourglass(ctx, block_expansion, num_channels, num_kp, num_blocks,
                                   max_features)

    def forward(self, x):
        if self.scale_factor != 1:
            x = resize_nearest(x, (int(x.shape[2] * self.scale_factor),
                                   int(x.shape[3] * self.scale_factor)))
        logits = self.predictor(x)
        B, D, H, W, K = logits.shape
        if not self.training:
            self.ctx.record("softargmax", B=B, D=D, H=H, W=W, K=K)
        return softargmax(logits, self.temperature, self.clip_variance)


class MovementEmbedding(nn.Module):
    """Per keypoint (background slot first where asked): [heatmap |
    kp difference | shifted source], interleaved per keypoint."""

    def __init__(self, ctx, num_kp, num_channels, use_deformed_source_image=False,
                 use_difference=False, use_heatmap=True, add_bg_feature_map=False,
                 heatmap_type="gaussian", norm_const="sum", scale_factor=1.0, kp_variance=None):
        super().__init__()
        self.ctx, self.num_kp, self.num_channels = ctx, num_kp, num_channels
        self.deformed, self.difference, self.heatmap = (use_deformed_source_image,
                                                         use_difference, use_heatmap)
        self.bg, self.heatmap_type = add_bg_feature_map, heatmap_type
        self.norm_const, self.scale_factor = norm_const, scale_factor

    @property
    def out_channels(self):
        per_kp = (int(self.heatmap) + 2 * int(self.difference)
                  + self.num_channels * int(self.deformed))
        return per_kp * (self.num_kp + int(self.bg))

    def _render(self, kp, h, w):
        B, D, K, _ = kp["mean"].shape
        if not self.training:
            self.ctx.record("heatmap", B=B, D=D, K=K, H=h, W=w)
        heat = kp2gaussian(kp, h, w)
        if self.norm_const == "sum":
            return heat / heat.sum(dim=(-1, -2), keepdim=True)
        return heat / self.norm_const

    def forward(self, source, kp_driving, kp_source):
        if self.scale_factor != 1:
            source = resize_nearest(source, (int(source.shape[2] * self.scale_factor),
                                             int(source.shape[3] * self.scale_factor)))
        B, _, h, w, C = source.shape
        D = kp_driving["mean"].shape[1]
        Kb = self.num_kp + int(self.bg)
        parts = []
        if self.heatmap:
            heat = self._render(kp_driving, h, w)
            if self.heatmap_type == "difference":
                heat = heat - self._render(kp_source, h, w)
            if self.bg:
                heat = torch.cat([torch.zeros_like(heat[:, :, :1]), heat], dim=2)
            parts.append(heat.to(source.dtype).permute(0, 1, 3, 4, 2)[..., None])
        diff = (kp_source["mean"] - kp_driving["mean"]).float()  # (B, D, K, 2)
        if self.bg:
            diff = torch.cat([torch.zeros_like(diff[:, :, :1]), diff], dim=2)
        if self.difference:
            parts.append(diff.to(source.dtype)[:, :, None, None].expand(B, D, h, w, Kb, 2))
        if self.deformed:
            grid = coordinate_grid(h, w, source.device)[None, None] + diff.reshape(
                B, D * Kb, 1, 1, 2)
            shifted = F.grid_sample(
                source[:, 0].permute(0, 3, 1, 2),
                grid.reshape(B, D * Kb * h, w, 2).to(source.dtype),
                mode="bilinear", padding_mode="zeros", align_corners=True)
            shifted = shifted.permute(0, 2, 3, 1).reshape(B, D, Kb, h, w, C)
            parts.append(shifted.permute(0, 1, 3, 4, 2, 5))
        return self.ctx.q(torch.cat(parts, dim=-1).reshape(B, D, h, w, -1))


class DenseMotion(nn.Module):
    def __init__(self, ctx, block_expansion, num_blocks, max_features, mask_embedding_params,
                 num_kp, num_channels, kp_variance, use_correction, use_mask, bg_init=2.0,
                 num_group_blocks=0, scale_factor=1.0):
        super().__init__()
        if not (use_mask and use_correction):
            raise NotImplementedError("the reference covers use_mask and use_correction")
        self.ctx, self.num_kp, self.scale_factor = ctx, num_kp, scale_factor
        self.mask_embedding = MovementEmbedding(ctx, num_kp, num_channels, add_bg_feature_map=True,
                                                **mask_embedding_params)
        ch = self.mask_embedding.out_channels
        self.group_blocks = nn.ModuleList(
            SameBlock(ctx, ch, ch, k=1, pad=0, groups=num_kp + 1) for _ in range(num_group_blocks))
        self.hourglass = Hourglass(ctx, block_expansion, ch, num_kp + 3, num_blocks, max_features)

    def forward(self, source, kp_driving, kp_source):
        if self.scale_factor != 1:
            source = resize_nearest(source, (int(source.shape[2] * self.scale_factor),
                                             int(source.shape[3] * self.scale_factor)))
        x = self.mask_embedding(source, kp_driving, kp_source)
        for block in self.group_blocks:
            x = F.leaky_relu(block(x), 0.2)
        out = self.hourglass(x)
        B, D, h, w, _ = out.shape
        self.ctx.record("combine", B=B, D=D, H=h, W=w, K=self.num_kp + 1)
        mask = torch.softmax(out[..., : self.num_kp + 1].float(), dim=-1)  # (B, D, h, w, K+1)
        diff = (kp_source["mean"] - kp_driving["mean"]).float()
        diff = torch.cat([torch.zeros_like(diff[:, :, :1]), diff], dim=2)  # (B, D, K+1, 2)
        rel = (mask[..., None] * diff[:, :, None, None]).sum(dim=-2)
        return rel + out[..., -2:].float() + coordinate_grid(h, w, out.device)[None, None]


class Generator(nn.Module):
    def __init__(self, ctx, num_channels, num_kp, kp_variance, block_expansion, max_features,
                 num_blocks, num_refinement_blocks, dense_motion_params, kp_embedding_params,
                 interpolation_mode="nearest"):
        super().__init__()
        self.ctx, self.mode = ctx, interpolation_mode
        self.appearance_encoder = Encoder(ctx, block_expansion, num_channels, num_blocks,
                                          max_features)
        self.dense_motion_module = DenseMotion(ctx, num_kp=num_kp, num_channels=num_channels,
                                               kp_variance=kp_variance, **dense_motion_params)
        self.kp_embedding_module = MovementEmbedding(ctx, num_kp, num_channels,
                                                     **kp_embedding_params)
        extra = self.kp_embedding_module.out_channels
        self.video_decoder = Decoder(ctx, block_expansion, num_channels, num_channels, num_blocks,
                                     max_features, extra=extra, last=False)
        features = self.video_decoder.out_channels
        self.refinement_module = nn.Sequential()
        for i in range(num_refinement_blocks):
            self.refinement_module.add_module(f"r{i}", ResBlock(ctx, features))
        self.refinement_module.add_module("conv-last", Conv(ctx, features, num_channels, 1, 0))

    def forward(self, source, kp_driving, kp_source):
        skips = self.appearance_encoder(source)
        flow = self.dense_motion_module(source, kp_driving, kp_source)
        warped = [warp(self.ctx, s[:, 0], resize(flow, (s.shape[2], s.shape[3]), self.mode))
                  for s in skips]
        embedding = self.kp_embedding_module(source, kp_driving, kp_source)
        skips = [torch.cat([s, resize(embedding, (s.shape[2], s.shape[3]), self.mode)], dim=-1)
                 for s in warped]
        out = self.refinement_module(self.video_decoder(skips))
        return {"video_prediction": self.ctx.q(torch.sigmoid(out)), "video_deformed": warped[0]}


class DiscDownBlock(nn.Module):
    def __init__(self, ctx, cin, cout, norm):
        super().__init__()
        self.conv = Conv(ctx, cin, cout, k=4, pad=0)
        self.norm = InstanceNorm(ctx, cout) if norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return avg_pool(F.leaky_relu(x, 0.2))


class Discriminator(nn.Module):
    def __init__(self, ctx, num_channels=3, num_kp=10, kp_variance="matrix", scale_factor=1.0,
                 block_expansion=64, num_blocks=4, max_features=512, kp_embedding_params=None):
        super().__init__()
        self.scale_factor = scale_factor
        self.kp_embedding = MovementEmbedding(ctx, num_kp, num_channels, **kp_embedding_params)
        cin = num_channels + self.kp_embedding.out_channels
        blocks = []
        for i in range(num_blocks):
            cout = min(max_features, block_expansion * 2 ** (i + 1))
            blocks.append(DiscDownBlock(ctx, cin, cout, norm=i != 0))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.conv = Conv(ctx, cin, 1, 1, 0)

    def forward(self, x, kp_driving, kp_source):
        maps = [x]
        if self.scale_factor != 1:
            x = resize_nearest(x, (int(x.shape[2] * self.scale_factor),
                                   int(x.shape[3] * self.scale_factor)))
        out = torch.cat([x, self.kp_embedding(x, kp_driving, kp_source)], dim=-1)
        for block in self.down_blocks:
            out = block(out)
            maps.append(out)
        maps.append(self.conv(out))
        return maps


def build(model_params: Dict, ctx: Optional[Ctx] = None, device="cpu") -> Dict[str, nn.Module]:
    """{'kp_detector', 'generator', 'discriminator'} of `model_params` (a
    config's model_params), uninitialised, on `device`."""
    ctx = ctx or Ctx()
    common = model_params["common_params"]
    with torch.device(device):
        return {
            "kp_detector": KPDetector(ctx, **model_params["kp_detector_params"], **common),
            "generator": Generator(ctx, **model_params["generator_params"], **common),
            "discriminator": Discriminator(ctx, **model_params["discriminator_params"], **common),
        }


def conv_fan_in(weight: torch.Tensor) -> int:
    return math.prod(weight.shape[1:])
