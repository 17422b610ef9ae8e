"""Chain-batched Hamiltonian Monte Carlo.

All chains advance together: the integrator calls ``value_and_grad_fn`` on
the whole chain-stacked position dict, so the fused multi-chain value+grad
(ops.softmax_glm) serves every chain with one pass over the data.

Every random draw of a step can be injected (``momentum=``, ``uniforms=``);
otherwise it comes from the explicit ``generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.integrators import IntegratorState, trajectory, velocity_verlet_batched
from ..ops.metrics import batched_diagonal_metric
from ..ops.tree import Params, tree_axpy_bcast, tree_where_bcast


class HMCState(NamedTuple):
    position: Params
    logdensity: torch.Tensor
    logdensity_grad: Params


class HMCInfo(NamedTuple):
    acceptance_prob: torch.Tensor
    is_accepted: torch.Tensor
    energy: torch.Tensor
    is_divergent: torch.Tensor
    num_integration_steps: torch.Tensor


def batched_init(positions: Params, value_and_grad_fn: Callable) -> HMCState:
    """Chain-batched state: ``value_and_grad_fn`` maps the batched positions
    to ((C,) values, batched grads)."""
    value, grad = value_and_grad_fn(positions)
    return HMCState(positions, value, grad)


def build_batched_kernel(
    value_and_grad_fn: Callable,
    num_integration_steps: int,
    divergence_threshold: float = 1000.0,
    grad_fn: Optional[Callable] = None,
):
    """Returns ``step(state, step_sizes, inv_mass, *, momentum=None,
    uniforms=None, generator=None) -> (state, info)``.

    State leaves have a leading chain axis C, ``state.logdensity`` and
    ``step_sizes`` are (C,), ``inv_mass`` leaves are chain-batched, and the
    info fields are (C,) vectors.  The trajectory length is fixed.

    ``grad_fn`` (positions -> batched grads): lazy-value trajectories.  The
    MH accept needs the log density only at the trajectory's end, so the
    first L-1 leapfrog steps call the cheaper grad-only function and
    ``value_and_grad_fn`` runs once, at the proposal.
    """
    if num_integration_steps < 1:
        raise ValueError("num_integration_steps must be >= 1")

    def step(state: HMCState, step_sizes: torch.Tensor, inv_mass: Params, *,
             momentum: Optional[Params] = None,
             uniforms: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        m = batched_diagonal_metric(inv_mass)
        if momentum is None:
            momentum = m.sample_momentum(state.position, generator)
        energy0 = -state.logdensity + m.kinetic_energy(momentum)     # (C,)

        start = IntegratorState(state.position, momentum, state.logdensity,
                                state.logdensity_grad)
        if grad_fn is None:
            integ = velocity_verlet_batched(value_and_grad_fn, m.kinetic_grad)
            end = trajectory(integ, num_integration_steps)(start, step_sizes)
        else:
            def cheap_vag(q):
                # the logdensity entry stays stale through the inner steps;
                # the accurate value is evaluated once below, at the proposal
                return state.logdensity, grad_fn(q)

            integ = velocity_verlet_batched(cheap_vag, m.kinetic_grad)
            mid = trajectory(integ, num_integration_steps - 1)(start, step_sizes)
            q, p = mid.position, mid.momentum
            p = tree_axpy_bcast(0.5 * step_sizes, mid.logdensity_grad, p)
            q = tree_axpy_bcast(step_sizes, m.kinetic_grad(p), q)
            value, g = value_and_grad_fn(q)
            p = tree_axpy_bcast(0.5 * step_sizes, g, p)
            end = IntegratorState(q, p, value, g)

        energy1 = -end.logdensity + m.kinetic_energy(end.momentum)  # (C,)
        delta = energy0 - energy1
        delta = torch.where(torch.isnan(delta),
                            torch.full_like(delta, -float("inf")), delta)
        accept_prob = torch.clamp(torch.exp(delta), max=1.0)
        is_divergent = torch.abs(delta) > divergence_threshold

        if uniforms is None:
            if generator is None:
                raise ValueError("pass uniforms= or an explicit generator=")
            uniforms = torch.rand(accept_prob.shape, generator=generator,
                                  dtype=accept_prob.dtype,
                                  device=accept_prob.device)
        accept = uniforms < accept_prob                              # (C,)
        new_state = HMCState(
            tree_where_bcast(accept, end.position, state.position),
            tree_where_bcast(accept, end.logdensity, state.logdensity),
            tree_where_bcast(accept, end.logdensity_grad, state.logdensity_grad),
        )
        info = HMCInfo(
            acceptance_prob=accept_prob,
            is_accepted=accept,
            energy=energy1,
            is_divergent=is_divergent,
            num_integration_steps=torch.full_like(accept_prob,
                                                  num_integration_steps),
        )
        return new_state, info

    return step
