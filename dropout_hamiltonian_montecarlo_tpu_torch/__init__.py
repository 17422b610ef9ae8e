"""PyTorch / CUDA port of dropout_hamiltonian_montecarlo_tpu.

The JAX package beside this one is the reference; this package imports torch
and never jax.  Ported so far: the headline MNIST-softmax HMC path (see
``bench.py``), with the fused softmax-GLM value+grad as a hand-written CUDA
kernel for Hopper (``csrc/softmax_glm.cu``).
"""

import torch


def full_f32_precision() -> None:
    """Turn TF32 off for float32 matmuls and convolutions.  A value that
    feeds an MH accept must be float32-accurate: low-precision logits put
    O(10) noise into a |log density| of ~1e5 and collapse dual averaging.
    Called by the entry points (bench, chip smoke)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
