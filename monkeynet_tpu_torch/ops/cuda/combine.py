"""Dense-motion combine: kernel and plain form.

Per pixel: softmax over the K+1 mask logits, times the frame's (K+1, 2)
displacement table (kp_source - kp_driving, zero background slot), plus the
correction, plus the identity grid -> the absolute f32 sampling grid.

Kernel: csrc/combine.cu, CUDA C++ for sm_90a. It replaces the TPU kernel of
monkeynet_tpu/ops/pallas/combine.py (`_forward`, the `pallas_call` of
`_kernel`), which tiles pixels on lanes to fit VMEM. Here one thread owns one
pixel and keeps its K+1 logits in registers and L1. It is bound by bytes:
(K+1) + 2 f32 read and 2 f32 written per pixel; the table stays in L1.

`combine_plain` is the plain version (`dense_motion_combine_reference`);
`combine` takes it for a CPU tensor and launches the kernel for a CUDA one.
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


def combine(logits, diff, corr):
    """The combine through the kernel for CUDA tensors, plain on the CPU.
    All three inputs are contiguous f32."""
    if logits.device.type == "cpu":
        return combine_plain(logits, diff, corr)
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


combine.launches = 0
