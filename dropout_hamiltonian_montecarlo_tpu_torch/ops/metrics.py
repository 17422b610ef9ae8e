"""Euclidean metric (mass matrix) for the chain-batched HMC kernel."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .tree import Params, tree_batched_dot, tree_mul, tree_randn_like


class Metric(NamedTuple):
    """Euclidean metric: p ~ N(0, M); K(p) = 0.5 p^T M^-1 p.

    ``sample_momentum(position, generator)``, ``kinetic_energy(momentum)`` and
    ``kinetic_grad(momentum)`` (= M^-1 p).  The Kronecker metric with its
    whitening maps is ops.kron_metric.KronMetric.
    """

    sample_momentum: Callable
    kinetic_energy: Callable
    kinetic_grad: Callable


def batched_diagonal_metric(inv_mass: Params) -> Metric:
    """Diagonal metric over chain-batched dicts: every leaf (of positions,
    momenta and ``inv_mass``) has a leading chain axis C, and
    kinetic_energy returns a per-chain (C,) vector."""
    sqrt_mass = {k: 1.0 / torch.sqrt(v) for k, v in inv_mass.items()}

    def sample_momentum(position: Params, generator: torch.Generator) -> Params:
        return tree_mul(sqrt_mass, tree_randn_like(position, generator))

    def kinetic_energy(momentum: Params) -> torch.Tensor:
        return 0.5 * tree_batched_dot(momentum, tree_mul(inv_mass, momentum))

    def kinetic_grad(momentum: Params) -> Params:
        return tree_mul(inv_mass, momentum)

    return Metric(sample_momentum, kinetic_energy, kinetic_grad)
