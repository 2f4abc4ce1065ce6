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
Three variants, and `softargmax_plan` picks one from the shape alone:

* 'staged': one block per frame copies the frame's H*W*K contiguous
  elements once into shared memory and runs every pass there (a 64x64x10
  frame is 163,840 bytes in f32, inside the 232,448 a block may use);
* 'split': frames too large for that (256x256x10, configs/vox-full.yaml's
  kp detector): a band of rows a block, read once in 4-element vectors, one
  online-softmax partial per keypoint and band, and a second tiny kernel
  that merges a frame's bands in a fixed order (two launches, one call);
* 'plane': one block per (frame, keypoint) plane reads it in place with
  stride K. For frames whose byte size is no multiple of 16 or that do not
  start on 16 bytes, or whose K has no block size for the other two.

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

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from monkeynet_tpu_torch.ops.cuda import _build
from monkeynet_tpu_torch.ops.gaussian import clip_covariance, gaussian2kp, spatial_softmax

SOURCE = "monkeynet_tpu_torch/csrc/softargmax.cu"
REPLACES = "monkeynet_tpu/ops/pallas/softargmax.py:76"

MAX_DYNAMIC_SHARED = 232_448  # bytes a block may use on sm_90 (227 KB)
MAX_THREADS = 1024
_TARGET_THREADS = 640
_PLANE_THREADS = 256  # kPlaneThreads in csrc/softargmax.cu
_SPLIT_MAX_THREADS = 640  # kSplitMaxThreads, __launch_bounds__ of softargmax_split_kernel
_SPLIT_THREADS = 320
_SPLIT_MIN_ROWS = 4
_SPLIT_VEC = 4  # kSplitVec: elements a vector
SMS = 132  # streaming multiprocessors of an H100 SXM
_SPLIT_STATS = 7  # kSplitStats: a partial's m and six sums
VARIANTS = ("staged", "split", "plane")


class SoftargmaxPlan(NamedTuple):
    variant: str  # 'staged' | 'split' | 'plane'
    threads: int
    shared_bytes: int  # dynamic shared memory the launch asks for
    rows: int = 0  # 'split': pixel rows a block owns (the last band may be shorter)


def _staged_thread_choices(unit, K, W):
    """Block sizes for the staged variant, best first: multiples of `unit` =
    lcm(32, K) within 1024 threads whose pixels per sweep, threads / K, are a
    multiple of W (a thread then stays in one column of the frame, and the
    kernel hoists that column's coordinate), largest first; then the
    multiples of `unit` within _TARGET_THREADS, down to `unit` itself."""
    fixed_col = [t for t in range(unit, MAX_THREADS + 1, unit) if (t // K) % W == 0]
    return fixed_col[::-1] + [unit * m for m in range(max(1, _TARGET_THREADS // unit), 0, -1)]


def _split_plan(H, W, K, dtype, frames):
    """The 'split' plan of `frames` (H, W, K) frames of `dtype`, or None
    where K has no block size for it. A thread reads vectors of V =
    _SPLIT_VEC elements, so V * threads must be a multiple of K (its element
    j then always belongs to keypoint (V t + j) % K). The block size is the
    largest such multiple of 32 within _SPLIT_MAX_THREADS whose V * threads
    / K pixels a sweep are a multiple of W (each element slot then stays in
    one column, and the kernel sums three products an element, not six);
    else the largest within _SPLIT_THREADS, or the least one within
    _SPLIT_MAX_THREADS. A band, a block's rows, is an equal share of the
    frame about H * frames / SMS rows high (about one block an SM for the
    call, as large as that allows, so a block's merge of its partials is paid
    once per band; at least _SPLIT_MIN_ROWS), in rows of a whole number of 16
    bytes, at most H. The
    block's partials take 28 bytes a (thread, element slot) of shared
    memory."""
    V = _SPLIT_VEC
    unit = 32 * K // math.gcd(K, 32 * V)
    if unit > _SPLIT_MAX_THREADS:
        return None
    fixed_col = [t for t in range(unit, _SPLIT_MAX_THREADS + 1, unit) if (V * t // K) % W == 0]
    threads = fixed_col[-1] if fixed_col else max(unit, _SPLIT_THREADS // unit * unit)
    step = 16 // math.gcd(W * K * dtype.itemsize, 16)  # rows whose bytes are 16-byte multiples
    bands = max(1, round(H / max(_SPLIT_MIN_ROWS, H * frames / SMS)))
    rows = -(-H // bands // step) * step  # the frame cut into about `bands` equal bands
    return SoftargmaxPlan("split", threads, 4 * _SPLIT_STATS * V * threads, min(rows, H))


def softargmax_plan(H, W, K, dtype, aligned=True, variant=None, frames=1) -> SoftargmaxPlan:
    """Which variant of the kernel runs `frames` (H, W, K) frames of logits
    of `dtype`, with how many threads a block, how much dynamic shared
    memory and, for 'split', the rows a block owns.

    'staged' needs a block size that is a multiple of 32 and of K (thread t
    then meets keypoint t % K in every sweep) within 1024 threads, the f32
    tile of H*W*K values plus 3 partials a thread and 3 results a keypoint
    within the shared memory of a block, and a frame whose byte size is a
    multiple of 16 (the copies are 16 bytes wide); `aligned` says whether the
    tensor's first byte is 16-byte aligned too. 'split' takes the aligned
    frames that 'staged' cannot hold, where K allows its block size
    (_split_plan). Anything else is 'plane'. `variant` asks for 'split' or
    'plane' where the frame allows it (tests and timings), and raises where
    it does not."""
    elements = H * W * K
    unit = math.lcm(32, K)
    whole = aligned and (elements * dtype.itemsize) % 16 == 0
    plan = None
    if whole and unit <= MAX_THREADS and variant is None:
        for threads in _staged_thread_choices(unit, K, W):
            shared = 4 * (elements + 3 * threads + 3 * K)
            if shared <= MAX_DYNAMIC_SHARED:
                plan = SoftargmaxPlan("staged", threads, shared)
                break
    if plan is None and whole and variant in (None, "split"):
        plan = _split_plan(H, W, K, dtype, frames)
    if plan is None and variant in (None, "plane"):
        plan = SoftargmaxPlan("plane", _PLANE_THREADS, 0)
    if plan is None or variant not in (None, plan.variant):
        raise ValueError(f"softargmax: no {variant!r} plan for ({H}, {W}, {K}) {dtype}")
    return plan


@functools.lru_cache(maxsize=None)
def grid_sums(H, W):
    """The sums over an (H, W) frame's pixels that the +1e-7 floor adds to
    the statistics: sum gx, sum gy, sum gx^2, sum gy^2, sum gx * gy, and
    H * W, with each coordinate i * (2 / (n - 1)) - 1 as the kernels form it
    (rounded once to f32), summed in f64."""
    def axis(n):
        return np.float32(np.arange(n) * np.float64(np.float32(2.0 / (n - 1))) - 1.0)

    gx, gy = axis(W).astype(np.float64), axis(H).astype(np.float64)
    return (H * gx.sum(), W * gy.sum(), H * (gx * gx).sum(), W * (gy * gy).sum(),
            gx.sum() * gy.sum(), float(H * W))


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
    `softargmax_stats.launches` and, per variant, in `launches_by_variant`
    (a 'split' call, two kernels, counts once)."""
    _build.refuse_grad(logits, "softargmax")
    if logits.device.type == "cpu":
        return softargmax_plain(logits, temperature)
    _build.require_cuda_tensor(logits, "softargmax logits", _build.DTYPE_CODES, 5)
    B, D, H, W, K = logits.shape
    plan = softargmax_plan(H, W, K, logits.dtype, aligned=logits.data_ptr() % 16 == 0,
                           frames=B * D)
    stats = launch_softargmax(logits, temperature, plan)
    softargmax_stats.launches += 1
    softargmax_stats.launches_by_variant[plan.variant] += 1
    return stats


def launch_softargmax(logits, temperature, plan):
    """Run the kernel under `plan` on CUDA logits (B, D, H, W, K) ->
    (B, D, K, 5) f32 statistics. Counts nothing: softargmax_stats does."""
    B, D, H, W, K = logits.shape
    stats = torch.empty((B, D, K, 5), dtype=torch.float32, device=logits.device)
    lib = _build.library()
    args = (B * D, H, W, K, float(temperature), _build.DTYPE_CODES[logits.dtype])
    stream = _build.stream_of(logits)
    with torch.cuda.device(logits.device):
        if plan.variant == "staged":
            status = lib.mk_softargmax_staged(logits.data_ptr(), stats.data_ptr(), *args,
                                              plan.threads, plan.shared_bytes, stream)
        elif plan.variant == "split":
            bands = -(-H // plan.rows)
            partials = torch.empty(B * D * bands * K * _SPLIT_STATS, dtype=torch.float32,
                                   device=logits.device)
            status = lib.mk_softargmax_split(logits.data_ptr(), partials.data_ptr(),
                                             stats.data_ptr(), *args, plan.threads, plan.rows,
                                             plan.shared_bytes, *grid_sums(H, W), stream)
        else:
            status = lib.mk_softargmax_plane(logits.data_ptr(), stats.data_ptr(), *args, stream)
    _build.check_launch(status, f"softargmax ({plan.variant})")
    return stats


softargmax_stats.launches = 0
softargmax_stats.launches_by_variant = dict.fromkeys(VARIANTS, 0)


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
