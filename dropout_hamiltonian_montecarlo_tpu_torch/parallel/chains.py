"""Chains sharded over ranks: each rank advances its chain block.

The JAX package shard_maps a chain-batched program over the 'chains' mesh
axis.  Here each rank runs the unchanged single-device code on its block, and
its generator carries the block (``ops/streams.py``): every draw site draws the
run's global tensor and keeps the block's rows.  A rank therefore draws what
the one-process run draws for its chains, and where the model computes each
chain from that chain's rows alone, its draws are the one-process run's, bit
for bit; a collective moves numbers and changes none.  Chain randomness does
not depend on the blocking, so no shard index is folded into any stream.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..inference.sampling import Posterior, sample_posterior
from .data import shard_data
from .mesh import RankLayout, chain_block, check_block, gather


def sample_batched_sharded(
    batched_kernel: Callable,     # (state, (c,) eps, inv_mass, *, generator) -> (state, info)
    states,                       # this rank's chain block of the batched state
    step_sizes: torch.Tensor,     # (c,)
    inv_mass,
    num_samples: int,
    layout: RankLayout,
    *,
    generator: torch.Generator,
    data=None,
    kernel_factory: Optional[Callable] = None,
    post_step: Optional[Callable] = None,
):
    """Advance this rank's chain block ``num_samples`` draws through the
    chain-batched kernel (the fused one of the headline bench, or lockstep
    NUTS).  ``generator`` carries the rank's block
    (``streams.block_generator(seed, device, chain_block(layout, C))``).

    ``post_step(state, *, generator) -> state``: a map after every draw on the
    same generator (the whitened gauge Gibbs move).

    ``data`` + ``kernel_factory``: the global batch, and
    ``kernel_factory(local_batch) -> batched_kernel`` that builds the kernel
    on this rank's rows (``shard_data``) with a value and gradient summed over
    ``layout.data_group`` (``make_sharded_value_and_grad``).  The ranks of one
    chain block carry generators with the same seed and block, so they draw
    alike and their states stay equal.

    Returns (final_states, positions, infos) of the rank's block: positions
    leaves (c, T, ...), info fields (c, T).  ``gather`` assembles the global
    (C, T, ...) tensors."""
    c = step_sizes.shape[0]
    check_block(generator, chain_block(layout, c * layout.num_chain_shards))
    kernel = batched_kernel
    if data is not None:
        if kernel_factory is None:
            raise ValueError("data sharding needs a kernel_factory that builds the kernel on "
                             "the local rows with a summed value and gradient")
        kernel = kernel_factory(shard_data(data, layout))
    positions = {k: v.new_empty((c, num_samples) + v.shape[1:])
                 for k, v in states.position.items()}
    infos = None
    s = states
    for t in range(num_samples):
        s, info = kernel(s, step_sizes, inv_mass, generator=generator)
        if post_step is not None:
            s = post_step(s, generator=generator)
        for k, v in s.position.items():
            positions[k][:, t] = v
        if infos is None:
            infos = [f.new_empty((c, num_samples)) for f in info]
        for buf, f in zip(infos, info):
            buf[:, t] = f
    infos = type(info)(*infos) if num_samples > 0 else None
    return s, positions, infos


def sample_posterior_sharded(
    init_fn: Callable,
    kernel: Callable,
    initial_positions,            # this rank's chain block
    layout: RankLayout,
    num_samples: int,
    num_warmup: int = 500,
    num_chains: int = 1,          # the run's chains, all blocks together
    *,
    generator: torch.Generator,
    **kwargs,
) -> Posterior:
    """``sample_posterior`` on this rank's chain block of ``num_chains``:
    warmup and sampling of the per-chain kernels, every chain adapting its
    own step size (and inverse mass).  ``generator`` carries the block.

    The JAX package folds the shard index into each block's key, so its
    result depends on the mesh.  Here a block draws the one-process run's
    rows, so the result is the one-process run's rows whatever the number of
    shards (bit for bit where the model's products do not depend on the
    number of chains in a batch).  Returns the rank's ``Posterior``;
    ``gather`` assembles the chains."""
    block = chain_block(layout, num_chains)
    check_block(generator, block)
    return sample_posterior(init_fn, kernel, initial_positions, num_samples,
                            num_warmup=num_warmup, num_chains=block.size,
                            generator=generator, **kwargs)


__all__ = ["sample_batched_sharded", "sample_posterior_sharded", "gather"]
