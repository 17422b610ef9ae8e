"""Chain-batched velocity-Verlet (leapfrog) integrator."""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .tree import Params, tree_axpy_bcast


class IntegratorState(NamedTuple):
    position: Params
    momentum: Params
    logdensity: torch.Tensor
    logdensity_grad: Params


def velocity_verlet_batched(
    value_and_grad_fn: Callable[[Params], Tuple[torch.Tensor, Params]],
    kinetic_grad_fn: Callable[[Params], Params],
) -> Callable:
    """One leapfrog step for all chains: leaves carry a leading chain axis C,
    ``value_and_grad_fn`` maps the batched position to ((C,) values, batched
    grads) in ONE call (one pass over the data for every chain), and
    ``step_size`` is a per-chain (C,) vector."""

    def step(state: IntegratorState, step_size: torch.Tensor) -> IntegratorState:
        q, p, _, g = state
        p = tree_axpy_bcast(0.5 * step_size, g, p)
        v = kinetic_grad_fn(p)
        q = tree_axpy_bcast(step_size, v, q)
        value, g = value_and_grad_fn(q)
        p = tree_axpy_bcast(0.5 * step_size, g, p)
        return IntegratorState(q, p, value, g)

    return step


def trajectory(integrator_step: Callable, num_steps: int) -> Callable:
    """``num_steps`` integrator steps in a row."""

    def run(state: IntegratorState, step_size: torch.Tensor) -> IntegratorState:
        for _ in range(num_steps):
            state = integrator_step(state, step_size)
        return state

    return run
