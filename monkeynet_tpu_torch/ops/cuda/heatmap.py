"""Keypoint gaussian heatmaps with their normalisation: kernel and plain form.

Per (frame, keypoint): exp(-q/2) on the [-1, 1]^2 grid ('matrix', 'single' or
scalar variance), then divided by the plane's sum ('sum'), by a constant, or
not at all -> (B, D, K, H, W) f32.

Kernel: csrc/heatmap.cu, CUDA C++ for sm_90a. It replaces the TPU kernel of
monkeynet_tpu/ops/pallas/heatmap.py (`kp2gaussian_pallas`, the `pallas_call`
of `_kernel`). One block renders one plane from a few scalars; it is bound by
the bytes it writes. The determinant is a*d - b*c, as kp2gaussian computes
it, not the TPU kernel's a*d - ((b+c)/2)^2, which holds only for symmetric
covariances.

`heatmap_plain` is the plain version (kp2gaussian, then the movement
embedding's normalisation); `heatmap` takes it for a CPU tensor and launches
the kernel for a CUDA one.

The kernel is forward-only, like the TPU kernel, which has no VJP and which
the JAX package runs only outside training. So the wrapper refuses, on any
device, keypoints that require grad while grad is enabled: a kernel result
has no `grad_fn`. `MovementEmbedding` calls `heatmap_plain` in training mode.
"""

from __future__ import annotations

import torch

from monkeynet_tpu_torch.ops.cuda import _build
from monkeynet_tpu_torch.ops.gaussian import kp2gaussian

SOURCE = "monkeynet_tpu_torch/csrc/heatmap.cu"
REPLACES = "monkeynet_tpu/ops/pallas/heatmap.py:92"

_VAR_MODES = {"matrix": 0, "single": 1}  # anything else: a scalar variance (2)


def normalize_heatmap(heat, norm_const):
    """heat (B, D, K, H, W) / its plane sum ('sum') or a constant."""
    if norm_const is None:
        return heat
    if norm_const == "sum":
        return heat / heat.sum(dim=(-1, -2), keepdim=True)
    return heat / norm_const


def heatmap_plain(kp, spatial_size, kp_variance="matrix", norm_const=None):
    return normalize_heatmap(kp2gaussian(kp, spatial_size, kp_variance), norm_const)


def heatmap(kp, spatial_size, kp_variance="matrix", norm_const=None):
    """Rendered (and normalised) gaussians through the kernel for CUDA
    keypoints, plain on the CPU."""
    mean = kp["mean"]
    for value in kp.values():
        _build.refuse_grad(value, "heatmap")
    if mean.device.type == "cpu":
        return heatmap_plain(kp, spatial_size, kp_variance, norm_const)
    B, D, K, _ = mean.shape
    H, W = spatial_size
    mean = mean.float().contiguous()
    _build.require_cuda_tensor(mean, "heatmap mean", (torch.float32,), 4)
    if isinstance(kp_variance, str):
        if kp_variance not in _VAR_MODES:
            raise ValueError(f"heatmap: unknown kp_variance {kp_variance!r}")
        var_mode = _VAR_MODES[kp_variance]
    else:
        var_mode = 2
    var = None
    if var_mode != 2:
        var = kp["var"].float().contiguous()
        _build.require_cuda_tensor(var, "heatmap var", (torch.float32,), 5)
        want = (B, D, K, 2, 2) if var_mode == 0 else (B, D, K, 1, 1)
        if tuple(var.shape) != want or var.device != mean.device:
            raise ValueError(f"heatmap: var {tuple(var.shape)}, expected {want}")
    scalar_var = 0.0 if var_mode != 2 else float(kp_variance)
    if norm_const is None:
        norm_mode, norm_value = 0, 1.0
    elif norm_const == "sum":
        norm_mode, norm_value = 1, 1.0
    else:
        norm_mode, norm_value = 2, float(norm_const)
    out = torch.empty((B, D, K, H, W), dtype=torch.float32, device=mean.device)
    lib = _build.library()
    with torch.cuda.device(mean.device):
        status = lib.mk_heatmap_fwd(
            mean.data_ptr(), None if var is None else var.data_ptr(), out.data_ptr(),
            B * D * K, H, W, var_mode, scalar_var, norm_mode, norm_value,
            _build.stream_of(mean),
        )
    _build.check_launch(status, "heatmap")
    heatmap.launches += 1
    return out


heatmap.launches = 0
