"""Data-parallel SG-MCMC over a (chains, data) layout of ranks.

The JAX package shard_maps the per-chain driver over a (chains, data) mesh
with each chain's keys replicated along 'data'.  Here:

- every rank holds its rows of the dataset (``shard_data``), laid once;
- a rank advances its chain block, and its generator carries that block
  and is seeded alike on every data shard of the block, so the ranks of a
  block draw the same minibatch indices (into their own rows: the
  stratified uniform minibatch estimator), the same noise and the same
  dropout masks, and their chain states stay equal;
- each rank gathers ``batch_size / data_shards`` local rows a step, and the
  kernel's value-and-gradient hook sums the value and the gradient over the
  block's ranks (``make_sharded_value_and_grad``);
- the loop is the unchanged single-device ``run_sgmcmc_chains``.

With one data shard this is ``run_sgmcmc_chains``, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..inference.sgmcmc import run_sgmcmc_chains
from .data import shard_data
from .mesh import RankLayout, chain_block, check_block

Batch = Tuple[torch.Tensor, ...]


def run_sgmcmc_data_parallel(
    kernel: Callable,        # built with value_and_grad_fn=make_sharded_value_and_grad(...)
    initial_states,          # this rank's chain block, leaves (c, ...)
    num_chains: int,         # the run's chains, all blocks together
    data: Batch,             # the full dataset; each rank keeps its rows
    layout: RankLayout,
    batch_size: int,         # the GLOBAL minibatch per chain, split over the data shards
    num_steps: int,
    step_size_schedule: Callable,
    collect_every: int = 1,
    burnin_steps: int = 0,
    *,
    generator: torch.Generator,
):
    """Run this rank's chain block under ``layout``.  ``kernel`` must carry
    the summed value and gradient (a kernel built on a plain log density
    would follow shard-local gradients).  ``generator`` carries
    ``chain_block(layout, num_chains)`` and the same seed on every data shard
    of the block.  Returns (final_states, positions, infos) of the block:
    positions leaves (c, T, ...)."""
    ds = layout.num_data_shards
    if batch_size % ds != 0:
        raise ValueError(f"batch_size {batch_size} % {ds} data shards != 0")
    if data[0].shape[0] % ds != 0:
        raise ValueError(f"{data[0].shape[0]} rows % {ds} data shards != 0: the stratified "
                         f"minibatch draws the same local indices on every shard")
    block = chain_block(layout, num_chains)
    check_block(generator, block)
    return run_sgmcmc_chains(kernel, initial_states, block.size, shard_data(data, layout),
                             batch_size=batch_size // ds, num_steps=num_steps,
                             step_size_schedule=step_size_schedule,
                             collect_every=collect_every, burnin_steps=burnin_steps,
                             generator=generator)
