"""Keypoint gaussian heatmaps with their normalisation: kernel and plain form.

Per (frame, keypoint): exp(-q/2) on the [-1, 1]^2 grid ('matrix', 'single' or
scalar variance), then divided by the plane's sum ('sum'), by a constant, or
not at all -> (B, D, K, H, W) f32.

Kernel: csrc/heatmap.cu, CUDA C++ for sm_90a. It replaces the TPU kernel of
monkeynet_tpu/ops/pallas/heatmap.py (`kp2gaussian_pallas`, the `pallas_call`
of `_kernel`). It reads six scalars a plane and is bound by the bytes it
writes: two blocks per SM walk over the planes, each thread keeps its columns
and walks down the rows, and stores are 16 bytes wide where W % 4 == 0
(`heatmap_plan` decides that, and whether 'sum' holds the plane in registers
or evaluates it twice, from the shape alone). The determinant is a*d - b*c,
as kp2gaussian computes it, not the TPU kernel's a*d - ((b+c)/2)^2, which
holds only for symmetric covariances.

`heatmap_plain` is the plain version (kp2gaussian, then the movement
embedding's normalisation); `heatmap` takes it for a CPU tensor and launches
the kernel for a CUDA one.

The kernel is forward-only, like the TPU kernel, which has no VJP and which
the JAX package runs only outside training. So the wrapper refuses, on any
device, keypoints that require grad while grad is enabled: a kernel result
has no `grad_fn`. `MovementEmbedding` calls `heatmap_plain` in training mode.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from monkeynet_tpu_torch.ops.cuda import _build
from monkeynet_tpu_torch.ops.gaussian import kp2gaussian

SOURCE = "monkeynet_tpu_torch/csrc/heatmap.cu"
REPLACES = "monkeynet_tpu/ops/pallas/heatmap.py:92"

_VAR_MODES = {"matrix": 0, "single": 1}  # anything else: a scalar variance (2)
THREADS = 256  # kThreads in csrc/heatmap.cu
HOLD_ROWS = 4  # kHoldRows: rows of a plane a thread may keep in registers for 'sum'
BLOCKS_PER_SM = 2


class HeatmapPlan(NamedTuple):
    vector: int  # f32 values per store: 4 (16 bytes) or 1
    sum_mode: Optional[str]  # None unless norm_const == 'sum': 'registers' | 'recompute'


def heatmap_plan(H, W, norm_const) -> HeatmapPlan:
    """How the kernel stores and, for 'sum', normalises an (H, W) plane.

    Stores are 16 bytes wide where W % 4 == 0 (planes are then 16-byte
    aligned in the output the wrapper allocates), scalar otherwise. A block's
    256 threads sit side by side along a row, W / vector of them (at most
    256), and the rest of the block takes further rows; a thread walks down
    from its row in steps of that many rows. 'sum' keeps the plane in
    registers across the reduction where one sweep of columns covers the
    width and a thread meets at most HOLD_ROWS rows; a larger plane is
    evaluated twice.
    """
    vector = 4 if W % 4 == 0 else 1
    if norm_const != "sum":
        return HeatmapPlan(vector, None)
    cols = W // vector
    if cols <= THREADS and -(-H // (THREADS // cols)) <= HOLD_ROWS:
        return HeatmapPlan(vector, "registers")
    return HeatmapPlan(vector, "recompute")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    plan = heatmap_plan(H, W, norm_const)
    planes = B * D * K
    device_index = mean.device.index if mean.device.index is not None \
        else torch.cuda.current_device()
    blocks = max(1, min(planes, BLOCKS_PER_SM * _sm_count(device_index)))
    lib = _build.library()
    with torch.cuda.device(mean.device):
        status = lib.mk_heatmap_fwd(
            mean.data_ptr(), None if var is None else var.data_ptr(), out.data_ptr(),
            planes, H, W, var_mode, scalar_var, norm_mode, norm_value,
            plan.vector, int(plan.sum_mode == "registers"), blocks, _build.stream_of(mean),
        )
    _build.check_launch(status, "heatmap")
    heatmap.launches += 1
    return out


heatmap.launches = 0
