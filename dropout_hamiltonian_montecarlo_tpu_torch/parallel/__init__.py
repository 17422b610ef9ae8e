"""Scale-out over ``torch.distributed``: a (chains, data) layout of ranks,
sharded chains, data-parallel gradients.

The JAX package lays chains and data over a device mesh driven by one
program.  The port runs one process per rank (``torchrun``), each the
unchanged single-device code on its chain block and data shard; the
collectives are an all-reduce of gradients over the ranks of a chain block
and a gather of draws over the chain blocks.
"""

from .mesh import (RankLayout, chain_block, gather, init_distributed, local_device,
                   make_layout)
from .chains import sample_batched_sharded, sample_posterior_sharded
from .data import make_sharded_logdensity, make_sharded_value_and_grad, shard_data
from .sgmcmc import run_sgmcmc_data_parallel

__all__ = [
    "RankLayout",
    "make_layout",
    "init_distributed",
    "local_device",
    "chain_block",
    "gather",
    "sample_posterior_sharded",
    "sample_batched_sharded",
    "shard_data",
    "make_sharded_logdensity",
    "make_sharded_value_and_grad",
    "run_sgmcmc_data_parallel",
]
