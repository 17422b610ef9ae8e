"""Carry parameters, sampler states, metric setups and sample files between
the JAX package and the port.

Nothing here imports jax: a JAX array converts through ``np.asarray``, and a
JAX NamedTuple is recognised by its type's name.  ``load_gn_setup(npz_path,
alpha, device)`` reads a metric setup written by either package (see
ops.kron_metric).  A sample file (io.backend) has one layout in both
packages, (draws, chains, ...) per dataset; ``draws_from_sample_file`` and
``draws_to_numpy`` turn what ``HDF5Backend.read()`` gives into the (chains,
draws, ...) form that either package's ``summarize`` takes."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..inference.hmc import HMCState
from ..inference.metropolis import MHState
from ..inference.nuts import NUTSState
from ..inference.sgd import SGDState
from ..inference.sgmcmc import SGHMCState, SGLDState
from ..inference.smc import SMCState
from ..inference.vi import MeanFieldState
from ..ops.adaptation import DualAveragingState, WelfordState
from ..ops.kron_metric import load_gn_setup  # noqa: F401  (re-exported)
from ..ops.metrics import Metric, dense_metric_from_eigh
from ..ops.tree import Params

_STATE_TYPES = {cls.__name__: cls for cls in (
    HMCState, NUTSState, MHState, WelfordState, DualAveragingState, SGLDState, SGHMCState,
    SGDState, MeanFieldState, SMCState)}


def params_from_jax(obj, device, add_chain_axis: bool = False):
    """JAX arrays (as numpy or anything ``np.asarray`` takes) -> tensors on
    ``device``, same structure: a parameter dict (single-chain {'weights':
    (D, K), 'bias': (K,)}, the MLP's six leaves, or chain-batched), or a JAX
    ``HMCState``, ``NUTSState``, ``MHState``, ``WelfordState``,
    ``DualAveragingState``, ``SGLDState``, ``SGHMCState``, ``SGDState``,
    ``MeanFieldState`` or ``SMCState``, which becomes the port's type of the
    same name.

    ``add_chain_axis``: the JAX object is one chain's (what a per-chain JAX
    kernel sees under ``vmap``); every leaf gets a leading chain axis of 1,
    which every sampler state of the port carries (a ``MeanFieldState`` has
    no chain axis in either package, and an ``SMCState``'s particle axis is
    its chain axis: convert those without it).  Floating leaves become float32,
    integer and bool leaves keep their kind; a ``WelfordState``'s count, one
    scalar shared by all chains, becomes a float."""
    if isinstance(obj, Mapping):
        return {k: params_from_jax(v, device, add_chain_axis) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        name = type(obj).__name__
        if name not in _STATE_TYPES:
            raise TypeError(f"no counterpart in the port for a JAX {name}")
        fields = {f: params_from_jax(getattr(obj, f), device, add_chain_axis)
                  for f in obj._fields}
        if name == "WelfordState":
            fields["count"] = float(np.asarray(obj.count).reshape(-1)[0])
        return _STATE_TYPES[name](**fields)
    arr = np.array(obj)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    t = torch.as_tensor(arr, device=device)
    return t[None] if add_chain_axis else t


def dense_metric_from_jax(s, U, position_like: Params) -> Metric:
    """The port's dense metric from the eigendecomposition ``(s, U)`` of the
    mass matrix as the JAX package's ``dense_metric`` computed it
    (``jnp.linalg.eigh``, as numpy): the whitened coordinates then have the
    same signs and order in both packages.  ``position_like`` is a
    chain-batched dict on the target device."""
    leaf = next(iter(position_like.values()))
    f32 = dict(dtype=torch.float32, device=leaf.device)
    return dense_metric_from_eigh(torch.as_tensor(np.array(s), **f32),
                                  torch.as_tensor(np.array(U), **f32), position_like)


def draws_from_sample_file(stored: Mapping, device) -> Params:
    """What ``HDF5Backend.read()`` of either package returns, numpy arrays
    (draws, chains, ...) as a streaming run appends them, -> tensors on
    ``device`` with (chains, draws, ...) leading axes, as the port's
    ``summarize`` takes them."""
    return {k: torch.as_tensor(np.asarray(v), device=device).transpose(0, 1)
            for k, v in stored.items()}


def draws_to_numpy(draws: Params):
    """The port's (chains, draws, ...) tensors -> numpy arrays of the same
    layout, which the JAX package's ``summarize`` takes (through
    ``jnp.asarray``)."""
    return {k: np.ascontiguousarray(v.detach().cpu().numpy()) for k, v in draws.items()}
