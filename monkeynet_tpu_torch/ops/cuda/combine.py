"""Dense-motion combine: kernel and plain form.

Per pixel: softmax over the K+1 mask logits, times the frame's (K+1, 2)
displacement table (kp_source - kp_driving, zero background slot), plus the
correction, plus the identity grid -> the absolute f32 sampling grid.

Kernel: csrc/combine.cu, CUDA C++ for sm_90a. It replaces the TPU kernel of
monkeynet_tpu/ops/pallas/combine.py (`_forward`, the `pallas_call` of
`_kernel`), which tiles pixels on lanes to fit VMEM. Here one thread owns one
pixel and keeps its K+1 logits in registers and L1. It is bound by bytes:
(K+1) + 2 f32 read and 2 f32 written per pixel; the table stays in L1.

`combine_plain` is the plain version (`dense_motion_combine_reference`).
`combine` goes through `CombineFunction`, whose forward takes the plain
version for a CPU tensor and launches the kernel for a CUDA one, and whose
backward is the closed form of the softmax and the table product in plain
PyTorch: the JAX package computes it outside any TPU kernel too
(`_bwd` of monkeynet_tpu/ops/pallas/combine.py). So a tensor that requires
grad always gets a result with a `grad_fn`.
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.ops.cuda import _build
from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

SOURCE = "monkeynet_tpu_torch/csrc/combine.cu"
REPLACES = "monkeynet_tpu/ops/pallas/combine.py:72"


def combine_plain(logits, diff, corr):
    """logits (B,D,h,w,K+1), diff (B,D,K+1,2), corr (B,D,h,w,2) ->
    absolute sampling grid (B,D,h,w,2)."""
    p = torch.softmax(logits, dim=-1)
    rel = torch.einsum("bdhwk,bdkc->bdhwc", p, diff) + corr
    grid = make_coordinate_grid(logits.shape[2:4], dtype=rel.dtype, device=rel.device)
    return rel + grid[None, None]


def combine_backward(logits, diff, g):
    """Closed-form gradients of the combine for the cotangent g
    (B,D,h,w,2): with p = softmax(logits) and t_k = g . d_k per pixel,
    dlogits = p * (t - sum_j p_j t_j), ddiff_k = sum_pix p_k g, dcorr = g."""
    p = torch.softmax(logits, dim=-1)
    ddiff = torch.einsum("bdhwk,bdhwc->bdkc", p, g)
    t = torch.einsum("bdhwc,bdkc->bdhwk", g, diff)
    dlogits = p * (t - (p * t).sum(dim=-1, keepdim=True))
    return dlogits, ddiff, g


def _combine_forward(logits, diff, corr):
    """Launch the kernel on contiguous f32 CUDA tensors."""
    f32 = (torch.float32,)
    _build.require_cuda_tensor(logits, "combine logits", f32, 5)
    _build.require_cuda_tensor(diff, "combine diff", f32, 4)
    _build.require_cuda_tensor(corr, "combine corr", f32, 5)
    B, D, H, W, K1 = logits.shape
    if (tuple(diff.shape) != (B, D, K1, 2) or tuple(corr.shape) != (B, D, H, W, 2)
            or diff.device != logits.device or corr.device != logits.device):
        raise ValueError(
            f"combine: shapes logits {tuple(logits.shape)}, diff "
            f"{tuple(diff.shape)}, corr {tuple(corr.shape)} do not agree"
        )
    out = torch.empty((B, D, H, W, 2), dtype=torch.float32, device=logits.device)
    lib = _build.library()
    with torch.cuda.device(logits.device):
        status = lib.mk_combine_fwd(
            logits.data_ptr(), diff.data_ptr(), corr.data_ptr(), out.data_ptr(),
            B * D, H, W, K1, _build.stream_of(logits),
        )
    _build.check_launch(status, "combine")
    combine.launches += 1
    return out


class CombineFunction(torch.autograd.Function):
    """The combine with its closed-form backward."""

    @staticmethod
    def forward(ctx, logits, diff, corr):
        ctx.save_for_backward(logits, diff)
        if logits.device.type == "cpu":
            return combine_plain(logits, diff, corr)
        return _combine_forward(logits, diff, corr)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, diff = ctx.saved_tensors
        return combine_backward(logits, diff, g)


def combine(logits, diff, corr):
    """The combine through the kernel for CUDA tensors, plain on the CPU,
    differentiable on both. All three inputs are contiguous f32."""
    return CombineFunction.apply(logits, diff, corr)


combine.launches = 0
