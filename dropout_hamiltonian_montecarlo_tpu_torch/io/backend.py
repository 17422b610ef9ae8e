"""HDF5 posterior-sample backend with streaming append and aggregation.

The file layout is the JAX package's: one resizable dataset per parameter
leaf, named by its ``/``-joined tree path, the draws on the leading axis (a
streaming block is (draws, chains, ...)), and, in a shard file,
``__chain_indices__`` with the global indices of the chains it holds.  A
sample file written by either package is read by the other.

``append`` takes tensors on any device (or numpy arrays) and makes one
device-to-host copy per block.  ``h5py`` is imported inside the functions
that need it: a machine without it still imports this module.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from .checkpoint import _flatten

CHAIN_INDICES = "__chain_indices__"


def _host_block(positions) -> Dict[str, np.ndarray]:
    """{dataset name: numpy array} of a block of tensors or arrays.  All
    device tensors are copied together and waited for once."""
    pairs = _flatten(positions)
    tensors = [leaf.detach() if isinstance(leaf, torch.Tensor) else None for _, leaf in pairs]
    if any(t is not None and t.is_cuda for t in tensors):
        tensors = [t.to("cpu", non_blocking=True) if t is not None and t.is_cuda else t
                   for t in tensors]
        torch.cuda.synchronize()
    return {name: (t.numpy() if t is not None else np.asarray(leaf))
            for (name, leaf), t in zip(pairs, tensors)}


class HDF5Backend:
    """Append-only posterior store: one resizable dataset per leaf."""

    def __init__(self, path: str, mode: str = "a"):
        import h5py

        self.path = path
        self._f = h5py.File(path, mode)

    def _names(self) -> List[str]:
        return [n for n in _walk(self._f) if n != CHAIN_INDICES]

    def append(self, positions) -> None:
        """``positions``: a dict (or tree) of tensors or arrays with a leading
        draws axis: a collection block."""
        for name, arr in _host_block(positions).items():
            if name not in self._f:
                self._f.create_dataset(name, data=arr, maxshape=(None,) + arr.shape[1:],
                                       chunks=True)
            else:
                ds = self._f[name]
                n0 = ds.shape[0]
                ds.resize(n0 + arr.shape[0], axis=0)
                ds[n0:] = arr
        self._f.flush()

    def read(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(self._f[k]) for k in self._names()}

    def num_draws(self) -> int:
        """Length of the leading (draws) axis; 0 for an empty file."""
        names = self._names()
        return int(self._f[names[0]].shape[0]) if names else 0

    def truncate(self, n: int) -> None:
        """Shrink every dataset to ``n`` draws (no-op where already <= n).

        The streaming sampler's crash recovery: a chunk's append and its
        checkpoint write are two operations, so a crash between them leaves
        the file one chunk ahead of the checkpoint's counter; a resume
        truncates back to the counter before it appends."""
        for name in self._names():
            ds = self._f[name]
            if ds.shape[0] > n:
                ds.resize(n, axis=0)
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _walk(group, prefix=""):
    import h5py

    for k, v in group.items():
        name = f"{prefix}{k}"
        if isinstance(v, h5py.Group):
            yield from _walk(v, name + "/")
        else:
            yield name


def local_chain_block(leaf, chain_indices=None, chain_axis: int = 1):
    """(block, global chain indices) of the chain rows a process appends.

    A process of a sharded run holds only its own chains, so ``leaf`` IS its
    block and ``chain_indices`` names the global chains it holds; None means
    all chains, 0 .. C-1 (the single-process run)."""
    n = leaf.shape[chain_axis]
    idx = np.arange(n) if chain_indices is None else np.asarray(chain_indices, np.int64)
    if idx.shape != (n,):
        raise ValueError(f"{idx.size} chain indices for a block of {n} chains")
    return leaf, idx


class ShardedHDF5Backend:
    """Per-process shard writer: process ``process_index`` appends the chain
    rows it holds to ``<base>_<process_index>.h5`` and stores their global
    indices once (``__chain_indices__``), so ``assemble_shards`` can put the
    draws back in global chain order.  With the defaults (process 0, all
    chains) this is one file holding every chain, so one caller serves both.
    Blocks are (draws, chains, ...).

    In a joined ``torch.distributed`` group the writers check at their first
    append that no two of them claim a chain: one all-gather of the index
    lists over ``group`` (default: every rank; the ranks of ``group`` are the
    ones that write, and each must append), and a clash raises on every rank
    before anything is written."""

    def __init__(self, base_path: str, mode: str = "a", chain_axis: int = 1,
                 process_index: int = 0, chain_indices=None, group=None):
        self.process_index = int(process_index)
        self.path = shard_paths(base_path, self.process_index + 1)[-1]
        self.chain_axis = chain_axis
        self._chain_indices = chain_indices
        self._group = group
        self._checked = False
        self._b = HDF5Backend(self.path, mode)
        # a reopened shard file pins this process's chains: an append whose
        # chains differ (another layout of processes) raises instead of
        # mis-attributing chains at reassembly
        self._indices = (np.asarray(self._b._f[CHAIN_INDICES])
                         if CHAIN_INDICES in self._b._f else None)

    def append(self, positions) -> None:
        for _, leaf in _flatten(positions):
            _, idx = local_chain_block(leaf, self._chain_indices, self.chain_axis)
            if self._indices is None:
                self._indices = idx
            elif not np.array_equal(self._indices, idx):
                raise ValueError(
                    f"chain ownership mismatch: shard file holds global chains "
                    f"{self._indices.tolist()} but this append's chains are {idx.tolist()}: "
                    f"the process layout differs from the earlier appends")
        if not self._checked:
            _check_no_clash(self._indices, self.process_index, self._group)
            self._checked = True
        self._b.append(positions)
        if CHAIN_INDICES not in self._b._f:
            self._b._f.create_dataset(CHAIN_INDICES, data=self._indices)
            self._b._f.flush()

    def read(self) -> Dict[str, np.ndarray]:
        return self._b.read()

    def num_draws(self) -> int:
        return self._b.num_draws()

    def truncate(self, n: int) -> None:
        self._b.truncate(n)

    def close(self) -> None:
        self._b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _check_no_clash(indices, process_index: int, group) -> None:
    """Raise when another writer of ``group`` claims one of ``indices``
    (nothing to check outside a joined group)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    claims = [None] * dist.get_world_size(group)
    dist.all_gather_object(claims, (process_index, np.asarray(indices).tolist()), group=group)
    owner: Dict[int, int] = {}
    clashes = []
    for proc, idx in claims:
        for c in idx:
            if c in owner:
                clashes.append((c, owner[c], proc))
            owner.setdefault(c, proc)
    if clashes:
        raise ValueError("shard writers claim the same chains: "
                         + ", ".join(f"chain {c} by processes {a} and {b}"
                                     for c, a, b in clashes[:8]))


def shard_paths(base_path: str, num_processes: int) -> List[str]:
    """The per-process file names ``ShardedHDF5Backend(base_path)`` writes."""
    root, ext = os.path.splitext(base_path)
    return [f"{root}_{p}{ext or '.h5'}" for p in range(num_processes)]


def assemble_shards(paths: Sequence[str], chain_axis: int = 1) -> Dict[str, np.ndarray]:
    """Per-process shard files -> global (draws, chains, ...) arrays, the
    chains in GLOBAL order by each file's ``__chain_indices__``.  Raises when
    two files claim the same chain or when the chains do not cover 0 .. C-1."""
    import h5py

    blocks: Dict[str, list] = {}
    indices = []
    for p in paths:
        with h5py.File(p, "r") as f:
            indices.append(np.asarray(f[CHAIN_INDICES]))
            for name in _walk(f):
                if name != CHAIN_INDICES:
                    blocks.setdefault(name, []).append(np.asarray(f[name]))
    all_idx = np.concatenate(indices)
    values, counts = np.unique(all_idx, return_counts=True)
    if (counts > 1).any():
        raise ValueError(f"shard files claim the same chains more than once: "
                         f"{values[counts > 1].tolist()}")
    order = np.argsort(all_idx)
    if not np.array_equal(all_idx[order], np.arange(all_idx.size)):
        raise ValueError(f"shard files do not cover a contiguous chain range: indices "
                         f"{np.sort(all_idx)}")
    return {name: np.take(np.concatenate(parts, axis=chain_axis), order, axis=chain_axis)
            for name, parts in blocks.items()}


def posterior_mean(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """Posterior mean across sample files, weighted by their draw counts."""
    import h5py

    sums: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}
    for p in paths:
        with h5py.File(p, "r") as f:
            for name in _walk(f):
                if name == CHAIN_INDICES:
                    continue
                arr = np.asarray(f[name])
                sums[name] = sums.get(name, 0.0) + arr.sum(axis=0)
                counts[name] = counts.get(name, 0) + arr.shape[0]
    return {k: sums[k] / counts[k] for k in sums}
