"""Hand-written CUDA kernels for Hopper (sources in monkeynet_tpu_torch/csrc/).

Each module holds a wrapper that launches its kernel for CUDA tensors and
takes the plain PyTorch version beside it for CPU tensors, and counts its
launches in `<wrapper>.launches`.
"""
