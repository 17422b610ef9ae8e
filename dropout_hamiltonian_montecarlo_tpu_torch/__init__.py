"""PyTorch / CUDA port of dropout_hamiltonian_montecarlo_tpu.

The JAX package beside this one is the reference; this package imports torch
and never jax.  Ported so far: the headline MNIST-softmax HMC path (see
``bench.py``) with the fused softmax-GLM value+grad as a hand-written CUDA
kernel for Hopper (``csrc/softmax_glm.cu``), config 3 (lockstep
chain-batched NUTS, ChEES, the diagnostics), configs 1-2 (the per-chain HMC,
NUTS and Metropolis kernels, Stan window warmup, the small models and the
``mvn-hmc`` / ``logistic-hmc`` / ``mnist-nuts`` CLI), and configs 4-6 on one
device: the dropout MLP with its masks inside the sampled potential, SGLD /
SGHMC, momentum SGD, mean-field ADVI, tempered SMC and the
``mnist-mlp-sgmcmc`` / ``mnist-vi`` / ``plantvillage-smc`` CLI; and the file
layer: HDF5 sample files both packages read, checkpoints, exact resume of
the streaming samplers, a bounded draw buffer, the HDF5 dataset readers
(``--save`` / ``--stream-chunk`` / ``--checkpoint`` / ``--resume`` /
``--data``).  The multi-device layer (``parallel/``) is still to port.

**The chain axis.**  The JAX package writes a sampler for one chain and runs
many under ``jax.vmap``.  PyTorch has no ``vmap`` over data-dependent Python
loops, so here every sampler state carries a leading chain axis C (C = 1 for
one chain): state leaves are (C, ...), step sizes, log densities and info
fields are (C,), a diagonal inverse mass has leaves (C, ...).  A "per-chain"
kernel is a chain-batched kernel with per-chain masks: each chain has its own
random draws, trajectory length, tree, step size and mass, and a chain that
has finished a masked loop is frozen by a select while the others go on,
which is what XLA makes of ``vmap(while_loop)``.  A ``logdensity_fn`` keeps
the JAX meaning, one chain's params dict -> scalar;
``ops.integrators.lift_value_and_grad`` is the one place where it is lifted
over the chain axis.  Every random number of a step can be injected;
otherwise it comes from an explicit ``torch.Generator`` through the helpers
of ``ops.streams``: a generator that carries a ``ChainBlock`` draws the rows
of its chains out of the full run's draw, and the streaming samplers draw
chunk i from the generator of (seed, stream, i), so neither the blocking of
the chain axis nor a stop and resume moves a chain's random numbers.
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
