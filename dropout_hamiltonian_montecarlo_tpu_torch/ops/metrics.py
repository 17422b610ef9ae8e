"""Euclidean metrics (mass matrices) for the Hamiltonian samplers.

Every map works on chain-batched dicts: leaves of positions, momenta and a
diagonal ``inv_mass`` carry a leading chain axis C, and ``kinetic_energy``
returns a per-chain (C,) vector.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import streams
from .tree import (Params, tree_add, tree_batch_ravel, tree_batched_dot, tree_mul,
                   tree_ones_like, tree_randn_like)


class Metric(NamedTuple):
    """Euclidean metric: p ~ N(0, M); K(p) = 0.5 p^T M^-1 p.

    ``sample_momentum(position, generator)``, ``kinetic_energy(momentum)`` and
    ``kinetic_grad(momentum)`` (= M^-1 p).

    ``sample_position(mean, eps)`` (optional): q = mean + M^-1/2-shaped map of
    the standard-normal ``eps``, so q ~ N(mean, M^-1): the Laplace
    approximation when M is the Hessian at the MAP.

    ``whiten`` / ``unwhiten`` (optional): the change of variables
    e = M^{1/2} dq and dq = M^{-1/2} e.  ``whiten_transpose`` and
    ``unwhiten_transpose`` are the transposes of these two linear maps; they
    carry a gradient from whitened to parameter space and back (per-chain
    NUTS with ``metric=``).  ops.kron_metric.KronMetric has the same names.
    """

    sample_momentum: Callable
    kinetic_energy: Callable
    kinetic_grad: Callable
    sample_position: Optional[Callable] = None
    whiten: Optional[Callable] = None
    unwhiten: Optional[Callable] = None
    whiten_transpose: Optional[Callable] = None
    unwhiten_transpose: Optional[Callable] = None


def diagonal_metric(inv_mass: Params) -> Metric:
    """Metric from a dict of diagonal inverse masses (M^-1), one per chain:
    ``inv_mass`` leaves are (C, ...)."""
    sqrt_mass = {k: 1.0 / torch.sqrt(v) for k, v in inv_mass.items()}

    def sample_momentum(position: Params, generator: torch.Generator) -> Params:
        return tree_mul(sqrt_mass, tree_randn_like(position, generator))

    def kinetic_energy(momentum: Params) -> torch.Tensor:
        return 0.5 * tree_batched_dot(momentum, tree_mul(inv_mass, momentum))

    def kinetic_grad(momentum: Params) -> Params:
        return tree_mul(inv_mass, momentum)

    return Metric(sample_momentum, kinetic_energy, kinetic_grad)


# every state of the port carries a chain axis, so the diagonal metric is the
# chain-batched one under both of the JAX package's names
batched_diagonal_metric = diagonal_metric


def unit_metric(position_like: Params) -> Metric:
    """Identity mass matrix."""
    return diagonal_metric(tree_ones_like(position_like))


def dense_metric_from_eigh(s: torch.Tensor, U: torch.Tensor,
                           position_like: Params) -> Metric:
    """Dense metric M = U diag(s) U^T over the raveled parameter vector, from
    its eigendecomposition (float32 tensors on the positions' device).
    ``position_like`` is a chain-batched dict; only its layout is used."""
    _, unravel = tree_batch_ravel(position_like)
    s = torch.clamp(s, min=1e-30)
    sqrt_s = torch.sqrt(s)

    def flat(tree: Params) -> torch.Tensor:
        return tree_batch_ravel(tree)[0]                        # (C, D)

    def sample_momentum(position: Params, generator: torch.Generator) -> Params:
        z = flat(position)
        eps = streams.randn(z.shape, generator=generator, dtype=z.dtype, device=z.device)
        return unravel((sqrt_s * eps) @ U.T)

    def kinetic_energy(momentum: Params) -> torch.Tensor:
        e = (flat(momentum) @ U) / sqrt_s
        return 0.5 * (e * e).sum(dim=1)

    def kinetic_grad(momentum: Params) -> Params:
        return unravel(((flat(momentum) @ U) / s) @ U.T)

    def sample_position(mean: Params, eps: torch.Tensor) -> Params:
        return tree_add(mean, unravel((eps / sqrt_s) @ U.T))

    def whiten(dq: Params) -> Params:
        return unravel(sqrt_s * (flat(dq) @ U))

    def unwhiten(e: Params) -> Params:
        return unravel((flat(e) / sqrt_s) @ U.T)

    # whiten = diag(sqrt s) U^T and unwhiten = U diag(1 / sqrt s) as matrices
    # on a chain's column vector; their transposes swap the order

    def whiten_transpose(g_e: Params) -> Params:
        return unravel((sqrt_s * flat(g_e)) @ U.T)

    def unwhiten_transpose(g_q: Params) -> Params:
        return unravel((flat(g_q) @ U) / sqrt_s)

    return Metric(sample_momentum, kinetic_energy, kinetic_grad, sample_position,
                  whiten, unwhiten, whiten_transpose, unwhiten_transpose)


def dense_metric(mass_matrix, position_like: Params) -> Metric:
    """Full (dense) mass matrix M over the raveled parameter vector: exact
    whitening for a target whose curvature is known in closed form, which a
    diagonal metric cannot give (cross-coordinate correlation).  One (D, D)
    eigendecomposition at build time, in float64 on the host; every map then
    runs in float32 where the positions lie."""
    leaf = next(iter(position_like.values()))
    M = np.asarray(torch.as_tensor(mass_matrix).detach().cpu(), np.float64)
    s, U = np.linalg.eigh(M)
    f32 = dict(dtype=torch.float32, device=leaf.device)
    return dense_metric_from_eigh(torch.as_tensor(s, **f32), torch.as_tensor(U, **f32),
                                  position_like)
