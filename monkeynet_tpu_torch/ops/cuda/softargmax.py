"""Soft-argmax of heatmap logits to keypoints: kernel and plain form.

Per (frame, keypoint) plane of (B, D, H, W, K) logits: temperature softmax
over the plane, the +1e-7 floor after it with no renormalisation, the mean
sum p*g and the centred second moments -> five f32 statistics
(mx, my, vxx, vxy, vyy). `softargmax` turns them into the keypoint dict and
applies clip_variance in plain PyTorch.

Kernel: csrc/softargmax.cu, CUDA C++ for sm_90a. It replaces the TPU kernel
of monkeynet_tpu/ops/pallas/softargmax.py (`gaussian2kp_pallas`, the
`pallas_call` of `_kernel`), which transposes the logits to (N*K, H, W)
planes first. Here one block reduces one plane read in place from the
channels-last logits. It is bound by bytes: the logits cross DRAM once and
20 bytes per plane are written. Unlike the TPU kernel, the keypoints stay
f32 whatever the logits' dtype, as the plain path returns them.

`softargmax_plain` is the plain version (spatial_softmax then gaussian2kp);
`softargmax` takes it for a CPU tensor and launches the kernel for a CUDA one.

The kernel is forward-only, like the TPU kernel, which has no VJP and which
the JAX package runs only outside training. So the wrapper refuses, on any
device, logits that require grad while grad is enabled: a kernel result has
no `grad_fn`, and training upstream of it would silently stop. `KPDetector`
takes `spatial_softmax` and `gaussian2kp` itself in training mode.
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.ops.cuda import _build
from monkeynet_tpu_torch.ops.gaussian import clip_covariance, gaussian2kp, spatial_softmax

SOURCE = "monkeynet_tpu_torch/csrc/softargmax.cu"
REPLACES = "monkeynet_tpu/ops/pallas/softargmax.py:76"


def softargmax_plain(logits, temperature):
    """(B, D, H, W, K) logits -> (B, D, K, 5) f32 statistics."""
    kp = gaussian2kp(spatial_softmax(logits, temperature), "matrix")
    var = kp["var"]
    return torch.cat(
        [kp["mean"], var[..., 0, 0, None], var[..., 0, 1, None], var[..., 1, 1, None]],
        dim=-1,
    )


def softargmax_stats(logits, temperature):
    """The statistics through the kernel for CUDA tensors, plain on the CPU.
    logits: contiguous (B, D, H, W, K) f32 or bf16."""
    _build.refuse_grad(logits, "softargmax")
    if logits.device.type == "cpu":
        return softargmax_plain(logits, temperature)
    _build.require_cuda_tensor(logits, "softargmax logits", _build.DTYPE_CODES, 5)
    B, D, H, W, K = logits.shape
    stats = torch.empty((B, D, K, 5), dtype=torch.float32, device=logits.device)
    lib = _build.library()
    with torch.cuda.device(logits.device):
        status = lib.mk_softargmax_fwd(
            logits.data_ptr(), stats.data_ptr(), B * D, H, W, K, float(temperature),
            _build.DTYPE_CODES[logits.dtype], _build.stream_of(logits),
        )
    _build.check_launch(status, "softargmax")
    softargmax_stats.launches += 1
    return stats


softargmax_stats.launches = 0


def softargmax(logits, temperature, kp_variance="matrix", clip_variance=None):
    """(B, D, H, W, K) logits -> f32 keypoint dict, as spatial_softmax
    followed by gaussian2kp compute it."""
    stats = softargmax_stats(logits, temperature)
    kp = {"mean": stats[..., :2]}
    if kp_variance == "matrix":
        var = torch.stack(
            [stats[..., 2], stats[..., 3], stats[..., 3], stats[..., 4]], dim=-1
        ).reshape(stats.shape[:-1] + (2, 2))
        if clip_variance:
            var = clip_covariance(var, clip_variance)
        kp["var"] = var
    elif kp_variance == "single":
        kp["var"] = ((stats[..., 2] + stats[..., 4]) * 0.5)[..., None, None]
    return kp
