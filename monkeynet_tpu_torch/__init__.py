"""PyTorch port of monkeynet_tpu for NVIDIA Hopper (H100).

Same public layouts as the JAX package: videos (B, D, H, W, C), keypoint
dicts {'mean': (B, D, K, 2), 'var': (B, D, K, 2, 2)}, grids (..., 2) in xy
order. The four TPU kernels of the forward path are CUDA kernels here
(ops/cuda/, sources in csrc/); every other op is plain PyTorch.
"""
