"""Compute ops of the PyTorch port: plain PyTorch, and the two hand-written
CUDA kernels (``warp_kernel``, ``gn_solve``) built from ``csrc/``."""
