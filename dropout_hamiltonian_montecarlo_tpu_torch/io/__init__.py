"""I/O layer: datasets, sample storage, checkpoint / resume."""

from . import datasets
from .backend import (
    HDF5Backend,
    ShardedHDF5Backend,
    assemble_shards,
    local_chain_block,
    posterior_mean,
    shard_paths,
)
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "datasets",
    "HDF5Backend",
    "ShardedHDF5Backend",
    "assemble_shards",
    "local_chain_block",
    "shard_paths",
    "posterior_mean",
    "save_checkpoint",
    "load_checkpoint",
]
