"""The program's kernels by name, what kind of work each device operation is,
and each kernel operation's byte bound.

`OPS` maps every `__global__` kernel of monkeynet_tpu_torch/csrc/*.cu to the
operation it belongs to; a plan of several launches (d_src 'binned': bin,
sort, gather; the soft-argmax 'split': split, merge) is one operation.
`KINDS` sorts every device operation of a trace into a kind by its name, the
program's kernels first (the table of scripts/profile_torch_port.py,
completed).

`op_bytes` is an operation's least traffic from its shapes: each input read
once and each output written once, in the dtype the program keeps it in
(features in the compute dtype; grids, keypoints, logits of the combine and
heatmaps in float32). At HBM_BYTES_PER_S that is the operation's bound. The
shapes come from the reference's `Recorder` on the `meta` device
(`path_ops`), never from the program.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Tuple

import torch

from benchmarks.reference import model as reference

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet

OPS = {
    "warp_fwd_kernel_small": "warp_fwd",
    "warp_fwd_kernel_vector": "warp_fwd",
    "warp_dsrc_kernel": "warp_dsrc",
    "warp_dsrc_bin_kernel": "warp_dsrc",
    "warp_dsrc_sort_kernel": "warp_dsrc",
    "warp_dsrc_gather_kernel": "warp_dsrc",
    "warp_dgrid_kernel_small": "warp_dgrid",
    "warp_dgrid_kernel_packed": "warp_dgrid",
    "combine_kernel": "combine",
    "softargmax_staged_kernel": "softargmax",
    "softargmax_plane_kernel": "softargmax",
    "softargmax_split_kernel": "softargmax",
    "softargmax_merge_kernel": "softargmax",
    "heatmap_kernel": "heatmap",
}
_PORT = re.compile(r"\b(" + "|".join(sorted(OPS, key=len, reverse=True)) + r")\b")

# kind -> pattern on the lowered name; the first match wins
KINDS = (
    ("convolution", r"conv|xmma|fprop|implicit|cudnn|wgrad|dgrad|winograd|nhwc|nchw"),
    ("matmul", r"gemm|cutlass|bmm|matmul"),
    ("optimizer", r"multi_tensor|foreach|adam"),
    ("elementwise", r"elementwise|vectorized|unrolled|where|clamp|pow|exp"),
    ("reduction", r"reduce|softmax|norm"),
    ("copy_cat_index", r"copy|cat|index|gather|memcpy|memset|fill"),
)


def port_kernel(name: str):
    """The program's kernel that a device operation's name is, or None."""
    match = _PORT.search(name)
    return match.group(1) if match else None


def kind_of(name: str) -> str:
    if port_kernel(name):
        return "port_kernels"
    low = name.lower()
    for kind, pattern in KINDS:
        if re.search(pattern, low):
            return kind
    return "other"


def op_bytes(op: str, s: Dict, itemsize: int) -> int:
    """Least bytes of one operation of `op` with shapes `s` (the Recorder's),
    features of `itemsize` bytes."""
    f32 = 4
    if op == "warp_fwd":  # image, grid -> out
        return (s["B"] * s["H"] * s["W"] * s["C"] * itemsize + s["B"] * s["N"] * 2 * f32
                + s["B"] * s["N"] * s["C"] * itemsize)
    if op == "warp_dsrc":  # grid, dout -> d_image
        return (s["B"] * s["N"] * 2 * f32 + s["B"] * s["N"] * s["C"] * itemsize
                + s["B"] * s["H"] * s["W"] * s["C"] * itemsize)
    if op == "warp_dgrid":  # image, grid, dout -> d_grid
        return (s["B"] * s["H"] * s["W"] * s["C"] * itemsize + s["B"] * s["N"] * 2 * f32
                + s["B"] * s["N"] * s["C"] * itemsize + s["B"] * s["N"] * 2 * f32)
    if op == "combine":  # logits, diff, corr -> grid
        px = s["B"] * s["D"] * s["H"] * s["W"]
        return (px * s["K"] + s["B"] * s["D"] * s["K"] * 2 + px * 2 + px * 2) * f32
    if op == "softargmax":  # logits -> mean and covariance (5 numbers a keypoint)
        frames = s["B"] * s["D"]
        return frames * s["H"] * s["W"] * s["K"] * itemsize + frames * s["K"] * 5 * f32
    if op == "heatmap":  # mean, covariance -> planes
        return s["B"] * s["D"] * s["K"] * (6 * f32 + s["H"] * s["W"] * f32)
    raise KeyError(op)


def path_ops(model_params: Dict, hw: Tuple[int, int], path: str, frames: int = 1,
             batch: int = 1, remat: bool = False) -> List[Tuple[str, Dict]]:
    """The kernel operations, with shapes, of one call of the program's path
    at these sizes, from the reference run on the `meta` device.

    'transfer_chunk': the keypoint detector on `frames` driving frames and
    the generator over them (the source's keypoints are counted apart, by
    'transfer_video'). 'train_step': the forward warps and combine (twice
    under `remat`, which recomputes them), a d_grid for each warp and a d_src
    for each warp whose source needs a gradient."""
    H, W = hw
    rec = reference.Recorder()
    nets = reference.build(model_params, reference.Ctx(recorder=rec), device="meta")
    K = model_params["common_params"]["num_kp"]
    kp = {"mean": torch.empty(batch, frames, K, 2, device="meta"),
          "var": torch.empty(batch, frames, K, 2, 2, device="meta")}
    kp_source = {k: v[:, :1] for k, v in kp.items()}
    source = torch.empty(batch, 1, H, W, 3, device="meta")
    if path == "transfer_video":
        nets["kp_detector"].eval()(source)
        return list(rec.ops)
    if path == "transfer_chunk":
        for net in nets.values():
            net.eval()
        nets["kp_detector"](torch.empty(batch, frames, H, W, 3, device="meta"))
        nets["generator"](source, kp, kp_source)
        return list(rec.ops)
    if path != "train_step":
        raise ValueError(path)
    for net in nets.values():
        net.train()
    nets["generator"](source, kp, kp_source)
    ops = []
    for op, s in rec.ops:
        ops += [(("warp_fwd" if op == "warp" else op), s)] * (2 if remat else 1)
        if op == "warp":
            ops.append(("warp_dgrid", s))
            if s["source_grad"]:
                ops.append(("warp_dsrc", s))
    return ops


def bytes_by_op(ops, itemsize: int) -> Counter:
    """{op: bytes} summed over `ops`, the program's names (warp -> warp_fwd)."""
    out = Counter()
    for op, s in ops:
        name = "warp_fwd" if op == "warp" else op
        out[name] += op_bytes(name, s, itemsize)
    return out


def itemsize_of(dtype_name) -> int:
    return torch.empty((), dtype=getattr(torch, dtype_name or "float32")).element_size()
