"""Chain-batched velocity-Verlet (leapfrog) integrator.

``lift_value_and_grad`` is the one place where a per-chain log density (one
chain's params dict -> scalar, the JAX package's ``logdensity_fn``) becomes
the chain-batched value+grad every sampler of the port calls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from .tree import Params, tree_axpy_bcast, tree_where_bcast


class IntegratorState(NamedTuple):
    position: Params
    momentum: Params
    logdensity: torch.Tensor
    logdensity_grad: Params


def lift_value_and_grad(logdensity_fn: Callable[[Params], torch.Tensor]) -> Callable:
    """One chain's ``logdensity_fn(params) -> scalar`` -> the chain-batched
    ``value_and_grad_fn(positions) -> ((C,) values, grads)`` over dicts whose
    leaves carry a leading chain axis: what
    ``jax.vmap(jax.value_and_grad(fn))`` is in the JAX package.

    A function marked ``chain_batched`` (``models.base.Model.make_logdensity``
    marks those of models written to broadcast over leading chain axes) is
    called once on the whole batch and differentiated by one
    ``torch.autograd.grad`` of the sum over chains: chain c's value depends on
    chain c's leaves only, so that is every chain's own gradient, at a
    fraction of the dispatch cost.  Any other function goes through ``vmap``
    of ``grad_and_value``; it must be written without in-place writes and
    without ``.item()``."""
    if getattr(logdensity_fn, "chain_batched", False):
        def value_and_grad_fn(positions: Params):
            keys = list(positions)
            with torch.enable_grad():
                leaves = [positions[k].detach().requires_grad_(True) for k in keys]
                value = logdensity_fn(dict(zip(keys, leaves)))
                grads = torch.autograd.grad(value.sum(), leaves, allow_unused=True)
            return value.detach(), {k: torch.zeros_like(q) if g is None else g
                                    for k, q, g in zip(keys, leaves, grads)}

        return value_and_grad_fn

    lifted = torch.func.vmap(torch.func.grad_and_value(logdensity_fn))

    def value_and_grad_fn(positions: Params):
        grad, value = lifted(positions)
        return value, grad

    return value_and_grad_fn


def lift_value(logdensity_fn: Callable[[Params], torch.Tensor]) -> Callable:
    """The chain-batched value alone (``lift_value_and_grad`` without the
    gradient): positions (leaves (C, ...)) -> (C,) log densities."""
    if getattr(logdensity_fn, "chain_batched", False):
        return logdensity_fn
    return torch.func.vmap(logdensity_fn)


def new_integrator_state(logdensity_fn: Callable, position: Params,
                         momentum: Params) -> IntegratorState:
    """Chain-batched state at ``position`` from a per-chain log density."""
    value, grad = lift_value_and_grad(logdensity_fn)(position)
    return IntegratorState(position, momentum, value, grad)


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


def velocity_verlet(logdensity_fn: Callable[[Params], torch.Tensor],
                    kinetic_grad_fn: Callable[[Params], Params]) -> Callable:
    """The leapfrog step of a per-chain log density, over the chain axis."""
    return velocity_verlet_batched(lift_value_and_grad(logdensity_fn), kinetic_grad_fn)


def trajectory(integrator_step: Callable, num_steps: Union[int, torch.Tensor],
               max_steps: Optional[int] = None) -> Callable:
    """``num_steps`` integrator steps in a row.

    An int runs that many steps for every chain.  A (C,) integer tensor is a
    per-chain count (jittered trajectory lengths): ``max_steps`` lockstep
    steps run, and a chain that has made its count is frozen, position,
    momentum, value and gradient alike, by a masked select (never by a
    product: a non-finite value in a frozen lane stays out).  The bound is a
    host int, so no count is read back from the device."""
    if isinstance(num_steps, int):
        def run(state: IntegratorState, step_size: torch.Tensor) -> IntegratorState:
            for _ in range(num_steps):
                state = integrator_step(state, step_size)
            return state
    else:
        if max_steps is None:
            raise ValueError("a per-chain num_steps needs max_steps")

        def run(state: IntegratorState, step_size: torch.Tensor) -> IntegratorState:
            for i in range(max_steps):
                new = integrator_step(state, step_size)
                state = tree_where_bcast(i < num_steps, new, state)
            return state

    return run
