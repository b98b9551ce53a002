"""Kernels and their plain PyTorch versions."""
