"""Kernels (CUDA sources in ``vipers_torch/csrc``) and token helpers."""
