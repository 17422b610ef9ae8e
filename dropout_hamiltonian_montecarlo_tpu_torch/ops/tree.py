"""Arithmetic over parameter dicts of tensors.

Parameters are flat dicts of tensors ({'weights': ..., 'bias': ...}); in the
chain-batched forms every leaf carries a leading chain axis C.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import streams

Params = Dict[str, torch.Tensor]


def tree_add(a: Params, b: Params) -> Params:
    """a + b, leafwise."""
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Params, b: Params) -> Params:
    """a - b, leafwise."""
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: Params, s) -> Params:
    """s * a for a scalar s, leafwise."""
    return {k: s * v for k, v in a.items()}


def tree_mul(a: Params, b: Params) -> Params:
    """a * b, leafwise (Hadamard)."""
    return {k: a[k] * b[k] for k in a}


def tree_axpy(s, x: Params, y: Params) -> Params:
    """y + s * x for a scalar s, leafwise."""
    return {k: y[k] + s * x[k] for k in x}


def tree_dot(a: Params, b: Params) -> torch.Tensor:
    """Full inner product over all leaves (a 0-d tensor); the per-chain form
    is ``tree_batched_dot``."""
    return sum((a[k] * b[k]).sum() for k in a)


def tree_zeros_like(a: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in a.items()}


def tree_ones_like(a: Params) -> Params:
    return {k: torch.ones_like(v) for k, v in a.items()}


def tree_size(a: Params) -> int:
    """Total number of scalars in the dict."""
    return sum(v.numel() for v in a.values())


def tree_ravel(a: Params):
    """One chain's dict -> (1-D vector, unravel), leaves in sorted key order
    (the order of ``jax.flatten_util.ravel_pytree``); the chain-batched form
    is ``tree_batch_ravel``."""
    mat, unravel = tree_batch_ravel({k: v[None] for k, v in a.items()})
    return mat[0], lambda z: {k: v[0] for k, v in unravel(z[None]).items()}


def tree_where(pred, a, b):
    """Leafwise select on one bool ``pred`` (a scalar, or anything that
    broadcasts against every leaf); dicts or tensors."""
    if isinstance(a, dict):
        return {k: torch.where(pred, a[k], b[k]) for k in a}
    return torch.where(pred, a, b)


def tree_randn_like(a: Params, generator: Optional[torch.Generator]) -> Params:
    """Standard-normal dict with the shapes of a chain-batched ``a`` (leaves
    (C, ...)), drawn from ``generator``, one draw per leaf."""
    return {k: streams.randn(v.shape, generator=generator, dtype=v.dtype,
                             device=v.device) for k, v in a.items()}


def tree_batch_randn_like(a: Params, generator: Optional[torch.Generator]) -> Params:
    """Standard-normal dict with the shapes of a chain-batched ``a`` (leaves
    (C, ...)), from ONE (C, P) draw cut into views: one launch, not one per
    leaf.  Leaves are cut in sorted key order, as ``tree_batch_ravel`` lays
    them."""
    keys = sorted(a)
    leaf = a[keys[0]]
    sizes = [math.prod(a[k].shape[1:]) for k in keys]
    z = streams.randn((leaf.shape[0], sum(sizes)), generator=generator, dtype=leaf.dtype,
                      device=leaf.device)
    return {k: piece.reshape(a[k].shape) for k, piece in zip(keys, z.split(sizes, dim=1))}


def _bcast(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape a (C,)-vector so it broadcasts against a (C, ...) leaf."""
    return v.reshape(v.shape + (1,) * (leaf.dim() - v.dim()))


def tree_axpy_bcast(s: torch.Tensor, x: Params, y: Params) -> Params:
    """y + s * x with a per-chain (C,) vector s over (C, ...) leaves."""
    return {k: y[k] + _bcast(s, x[k]) * x[k] for k in x}


def tree_where_bcast(pred: torch.Tensor, a, b):
    """Per-chain select over (C, ...) leaves; ``a``/``b`` may be tensors,
    dicts, or NamedTuples of these (a sampler state)."""
    if isinstance(a, dict):
        return {k: torch.where(_bcast(pred, a[k]), a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return type(a)(*(tree_where_bcast(pred, x, y) for x, y in zip(a, b)))
    return torch.where(_bcast(pred, a), a, b)


def tree_batch_ravel(a: Params):
    """Chain-batched dict (leaves (C, ...)) -> ((C, P) matrix, unravel).
    Leaves are laid side by side in sorted key order, the order of the JAX
    package's ``tree_batch_ravel`` (a {'weights', 'bias'} row is [bias,
    weights]).  ``unravel`` maps a (C, P) matrix back to the dict (views
    into it)."""
    keys = sorted(a)
    shapes = [a[k].shape[1:] for k in keys]
    sizes = [math.prod(s) for s in shapes]
    mat = torch.cat([a[k].reshape(a[k].shape[0], -1) for k in keys], dim=1)

    def unravel(z: torch.Tensor) -> Params:
        out, off = {}, 0
        for k, s, n in zip(keys, shapes, sizes):
            out[k] = z[:, off:off + n].reshape((z.shape[0],) + s)
            off += n
        return out

    return mat, unravel


def tree_batched_dot(a: Params, b: Params) -> torch.Tensor:
    """Per-chain inner product over (C, ...) leaves -> (C,) vector."""
    total = None
    for k in a:
        d = (a[k] * b[k]).reshape(a[k].shape[0], -1).sum(dim=1)
        total = d if total is None else total + d
    return total
