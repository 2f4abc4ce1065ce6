"""Hand-written CUDA kernels for Hopper (sources in monkeynet_tpu_torch/csrc/).

Each module holds a wrapper that launches its kernel for CUDA tensors and
takes the plain PyTorch version beside it for CPU tensors, and counts its
launches in `<wrapper>.launches`.
"""


def launch_counts() -> dict:
    """{wrapper: launches so far} of the six kernels' wrappers."""
    from monkeynet_tpu_torch.ops.cuda import combine, heatmap, softargmax, warp

    return {"warp": warp.warp.launches, "warp_dsrc": warp.warp_dsrc.launches,
            "warp_dgrid": warp.warp_dgrid.launches, "combine": combine.combine.launches,
            "softargmax": softargmax.softargmax_stats.launches,
            "heatmap": heatmap.heatmap.launches}
