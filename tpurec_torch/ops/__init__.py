"""Kernels of the port: CUDA wrappers and their plain PyTorch versions."""
