"""Wrappers of the CUDA kernels in csrc/, each with its plain PyTorch version."""
