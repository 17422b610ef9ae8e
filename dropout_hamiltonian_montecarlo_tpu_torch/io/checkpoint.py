"""Checkpoint / resume for sampler state.

A checkpoint holds what a streaming run needs to go on: the sampler state
(a NamedTuple of tensors and dicts), the adapted step sizes and inverse mass
(``extras``), the run's seed and the count of draws done.  One ``.npz`` with
the JAX package's keys: ``__step__``, ``state::<name>``,
``extra.<group>::<name>``, the names being the tree path joined by ``/`` (a
NamedTuple field as ``.field``, a tuple entry as its index, a dict entry as
its key: what ``jax.tree_util.tree_flatten_with_path`` gives the JAX package).

Checkpoints are NOT portable between the two packages, while sample files
are (io/backend.py): the JAX package stores threefry key data under
``__key__``, which no ``torch.Generator`` can continue, and the port stores
its run seed under ``__seed__`` (the chunk streams of ops/streams.py are a
function of the seed and the draw counter).  ``load_checkpoint`` says so when
it meets the other kind.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEED_KEY = "__seed__"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, leaf) pairs of a tree of NamedTuples, tuples, dicts and
    tensors; a None holds no leaf."""
    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], join(str(k)))]
    if isinstance(tree, tuple):
        names = ([f".{f}" for f in tree._fields] if hasattr(tree, "_fields")
                 else [str(i) for i in range(len(tree))])
        return [pair for n, v in zip(names, tree) for pair in _flatten(v, join(n))]
    return [(prefix, tree)]


def _rebuild(like, prefix: str, leaf_fn):
    """A tree of ``like``'s structure with ``leaf_fn(name, template_leaf)`` at
    every leaf."""
    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], join(str(k)), leaf_fn) for k in like}
    if isinstance(like, tuple):
        if hasattr(like, "_fields"):
            return type(like)(*(_rebuild(v, join(f".{f}"), leaf_fn)
                                for f, v in zip(like._fields, like)))
        return tuple(_rebuild(v, join(str(i)), leaf_fn) for i, v in enumerate(like))
    return leaf_fn(prefix, like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any, *, seed: int, step: int,
                    extras: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write (state, seed, step, extras) to ``path`` (.npz): the
    file is written as ``path + ".tmp"`` and moved over ``path``, so a crash
    leaves the old checkpoint or the new one, never half of one."""
    payload = {"__step__": np.asarray(step), SEED_KEY: np.asarray(int(seed), np.uint64)}

    def pack(prefix, tree):
        for name, leaf in _flatten(tree):
            payload[f"{prefix}::{name}"] = _to_numpy(leaf)

    pack("state", state)
    for group, tree in (extras or {}).items():
        pack(f"extra.{group}", tree)

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, state_like: Any,
                    extras_like: Optional[Dict[str, Any]] = None, block=None):
    """Load a checkpoint written by ``save_checkpoint``.  The trees are
    rebuilt in the structure of the templates, every leaf on its template's
    device and in its dtype; a leaf whose shape differs from its template's
    raises ``ValueError``.  Returns (state, seed, step, extras).

    ``block`` (an ``ops.streams.ChainBlock``): the checkpoint is global and
    every leaf has a leading chain axis; the templates are one rank's block
    of it, and each leaf is read at the block's rows.

    A checkpoint of the JAX package (``__key__`` and no ``__seed__``) raises
    ``ValueError``: checkpoints are not portable between the packages."""
    with np.load(path) as data:
        if SEED_KEY not in data.files:
            if "__key__" in data.files:
                raise ValueError(
                    f"{path} is a checkpoint of the JAX package (it holds threefry key "
                    f"data under __key__ and no {SEED_KEY}): checkpoints are not portable "
                    f"between the packages; resume it with the package that wrote it, or "
                    f"start the run again (sample files are portable)")
            raise ValueError(f"{path} is not a checkpoint of this package: no {SEED_KEY}")
        step = int(data["__step__"])
        seed = int(data[SEED_KEY])

        def unpack(prefix, like):
            def leaf(name, template):
                arr = data[f"{prefix}::{name}"]
                if block is not None:
                    if arr.shape[:1] != (block.global_chains,):
                        raise ValueError(f"checkpoint leaf {prefix}::{name} shape {arr.shape} "
                                         f"has no chain axis of {block.global_chains}")
                    arr = arr[block.start:block.stop]
                if tuple(arr.shape) != tuple(template.shape):
                    raise ValueError(f"checkpoint leaf {prefix}::{name} shape {arr.shape} != "
                                     f"template {tuple(template.shape)}")
                return torch.as_tensor(arr).to(device=template.device, dtype=template.dtype)

            return _rebuild(like, "", leaf)

        state = unpack("state", state_like)
        extras = {g: unpack(f"extra.{g}", t) for g, t in (extras_like or {}).items()}
    return state, seed, step, extras


def checkpoint_groups(path: str) -> List[str]:
    """The names of the extras groups a checkpoint holds (``step_size``,
    ``inv_mass``, ...)."""
    with np.load(path) as data:
        return sorted({k.split("::")[0][len("extra."):] for k in data.files
                       if k.startswith("extra.")})
