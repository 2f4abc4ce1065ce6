"""Soft-argmax of heatmap logits to keypoints: kernel and plain form.

Per (frame, keypoint) plane of (B, D, H, W, K) logits: temperature softmax
over the plane, the +1e-7 floor after it with no renormalisation, the mean
sum p*g and the centred second moments -> five f32 statistics
(mx, my, vxx, vxy, vyy). `softargmax` turns them into the keypoint dict and
applies clip_variance in plain PyTorch.

Kernel: csrc/softargmax.cu, CUDA C++ for sm_90a. It replaces the TPU kernel
of monkeynet_tpu/ops/pallas/softargmax.py (`gaussian2kp_pallas`, the
`pallas_call` of `_kernel`), which transposes the logits to (N*K, H, W)
planes first. It is bound by bytes: the logits in, 20 bytes per plane out.
Two variants, and `softargmax_plan` picks one from the shape alone:

* 'staged': one block per frame copies the frame's H*W*K contiguous
  elements once into shared memory and runs every pass there (a 64x64x10
  frame is 163,840 bytes in f32, inside the 232,448 a block may use);
* 'plane': one block per (frame, keypoint) plane reads it in place with
  stride K. For frames that do not fit (256x256x10), whose byte size is no
  multiple of 16, or whose K has no block size that is a multiple of 32 and
  of K within 1024 threads.

This is a dispatch on shape, made before the launch; it is no retreat after
a failed one: a refused launch raises. Unlike the TPU kernel, the keypoints
stay f32 whatever the logits' dtype, as the plain path returns them.

`softargmax_plain` is the plain version (spatial_softmax then gaussian2kp);
`softargmax` takes it for a CPU tensor and launches the kernel for a CUDA one.

The kernel is forward-only, like the TPU kernel, which has no VJP and which
the JAX package runs only outside training. So the wrapper refuses, on any
device, logits that require grad while grad is enabled: a kernel result has
no `grad_fn`, and training upstream of it would silently stop. `KPDetector`
takes `spatial_softmax` and `gaussian2kp` itself in training mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from monkeynet_tpu_torch.ops.cuda import _build
from monkeynet_tpu_torch.ops.gaussian import clip_covariance, gaussian2kp, spatial_softmax

SOURCE = "monkeynet_tpu_torch/csrc/softargmax.cu"
REPLACES = "monkeynet_tpu/ops/pallas/softargmax.py:76"

MAX_DYNAMIC_SHARED = 232_448  # bytes a block may use on sm_90 (227 KB)
MAX_THREADS = 1024
_TARGET_THREADS = 640
_PLANE_THREADS = 256  # kPlaneThreads in csrc/softargmax.cu


class SoftargmaxPlan(NamedTuple):
    variant: str  # 'staged' | 'plane'
    threads: int
    shared_bytes: int  # dynamic shared memory the launch asks for


def _staged_thread_choices(unit, K, W):
    """Block sizes for the staged variant, best first: multiples of `unit` =
    lcm(32, K) within 1024 threads whose pixels per sweep, threads / K, are a
    multiple of W (a thread then stays in one column of the frame, and the
    kernel hoists that column's coordinate), largest first; then the
    multiples of `unit` within _TARGET_THREADS, down to `unit` itself."""
    fixed_col = [t for t in range(unit, MAX_THREADS + 1, unit) if (t // K) % W == 0]
    return fixed_col[::-1] + [unit * m for m in range(max(1, _TARGET_THREADS // unit), 0, -1)]


def softargmax_plan(H, W, K, dtype, aligned=True) -> SoftargmaxPlan:
    """Which variant of the kernel runs (H, W, K) logits of `dtype`, with how
    many threads a block and how much dynamic shared memory.

    'staged' needs a block size that is a multiple of 32 and of K (thread t
    then meets keypoint t % K in every sweep) within 1024 threads, the f32
    tile of H*W*K values plus 3 partials a thread and 3 results a keypoint
    within the shared memory of a block, and a frame whose byte size is a
    multiple of 16 (the copies are 16 bytes wide); `aligned` says whether the
    tensor's first byte is 16-byte aligned too. Anything else is 'plane'.
    """
    elements = H * W * K
    unit = math.lcm(32, K)
    if aligned and unit <= MAX_THREADS and (elements * dtype.itemsize) % 16 == 0:
        for threads in _staged_thread_choices(unit, K, W):
            shared = 4 * (elements + 3 * threads + 3 * K)
            if shared <= MAX_DYNAMIC_SHARED:
                return SoftargmaxPlan("staged", threads, shared)
    return SoftargmaxPlan("plane", _PLANE_THREADS, 0)


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
    logits: contiguous (B, D, H, W, K) f32 or bf16. Launches are counted in
    `softargmax_stats.launches` and, per variant, in `launches_by_variant`."""
    _build.refuse_grad(logits, "softargmax")
    if logits.device.type == "cpu":
        return softargmax_plain(logits, temperature)
    _build.require_cuda_tensor(logits, "softargmax logits", _build.DTYPE_CODES, 5)
    B, D, H, W, K = logits.shape
    stats = torch.empty((B, D, K, 5), dtype=torch.float32, device=logits.device)
    plan = softargmax_plan(H, W, K, logits.dtype, aligned=logits.data_ptr() % 16 == 0)
    lib = _build.library()
    args = (logits.data_ptr(), stats.data_ptr(), B * D, H, W, K, float(temperature),
            _build.DTYPE_CODES[logits.dtype])
    with torch.cuda.device(logits.device):
        if plan.variant == "staged":
            status = lib.mk_softargmax_staged(*args, plan.threads, plan.shared_bytes,
                                              _build.stream_of(logits))
        else:
            status = lib.mk_softargmax_plane(*args, _build.stream_of(logits))
    _build.check_launch(status, f"softargmax ({plan.variant})")
    softargmax_stats.launches += 1
    softargmax_stats.launches_by_variant[plan.variant] += 1
    return stats


softargmax_stats.launches = 0
softargmax_stats.launches_by_variant = {"staged": 0, "plane": 0}


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
