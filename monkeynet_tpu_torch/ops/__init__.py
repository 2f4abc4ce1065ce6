"""Numeric ops: coordinate grids, 2x2 matrix math, sampling, gaussians.

Plain PyTorch forms live here; ops/cuda/ holds the hand-written kernels and
the wrappers that pick the kernel for CUDA tensors.
"""
