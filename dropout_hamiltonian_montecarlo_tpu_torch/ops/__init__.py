"""Tensor ops, metrics, integrators and the CUDA kernels' wrappers."""
