"""Hamiltonian Monte Carlo over an explicit chain axis.

Every state carries a leading chain axis C (C = 1 for one chain) and all
chains advance together.  ``build_batched_kernel`` takes a chain-batched
``value_and_grad_fn``, so the fused multi-chain value+grad (ops.softmax_glm)
serves every chain with one pass over the data.  ``build_kernel`` takes one
chain's ``logdensity_fn`` (params dict -> scalar), lifts it over the chain
axis, and adds per-chain jittered trajectory lengths and a ``metric=``
override: what ``jax.vmap`` of the JAX package's per-chain kernel is.  One
integrator/accept core serves both.

Every random draw of a step can be injected (``momentum=``, ``uniforms=``,
``jitter_uniforms=``); otherwise it comes from the explicit ``generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import streams
from ..ops.integrators import (IntegratorState, lift_value_and_grad, trajectory,
                               velocity_verlet_batched)
from ..ops.metrics import Metric, diagonal_metric
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


def _uniforms(given: Optional[torch.Tensor], like: torch.Tensor,
              generator: Optional[torch.Generator], name: str) -> torch.Tensor:
    """The injected (C,) uniforms, or fresh ones from ``generator``."""
    if given is not None:
        return given
    if generator is None:
        raise ValueError(f"pass {name}= or an explicit generator=")
    return streams.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)


def _build_step(value_and_grad_fn: Callable, num_integration_steps: int,
                divergence_threshold: float, grad_fn: Optional[Callable],
                jitter_steps: bool, metric: Optional[Metric]):
    """The one HMC step behind ``build_kernel`` and ``build_batched_kernel``:
    momentum draw, leapfrog trajectory (fixed, lazy-value, or per-chain
    jittered length), energy difference and per-chain MH accept."""
    if num_integration_steps < 1:
        raise ValueError("num_integration_steps must be >= 1")

    def step(state: HMCState, step_sizes: torch.Tensor, inv_mass: Optional[Params], *,
             momentum: Optional[Params] = None,
             uniforms: Optional[torch.Tensor] = None,
             jitter_uniforms: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        m = metric if metric is not None else diagonal_metric(inv_mass)
        if momentum is None:
            momentum = m.sample_momentum(state.position, generator)
        energy0 = -state.logdensity + m.kinetic_energy(momentum)     # (C,)

        start = IntegratorState(state.position, momentum, state.logdensity,
                                state.logdensity_grad)
        n_steps = torch.full_like(energy0, num_integration_steps)
        if jitter_steps:
            # per-chain n = max(ceil(u L), 1); all chains run L lockstep steps
            # and a chain past its n is frozen, so no count leaves the device
            u = _uniforms(jitter_uniforms, energy0, generator, "jitter_uniforms")
            n_steps = torch.clamp(torch.ceil(u * num_integration_steps), min=1).to(torch.int32)
            integ = velocity_verlet_batched(value_and_grad_fn, m.kinetic_grad)
            end = trajectory(integ, n_steps, max_steps=num_integration_steps)(start, step_sizes)
        elif grad_fn is None:
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

        accept = _uniforms(uniforms, accept_prob, generator, "uniforms") < accept_prob
        proposal = HMCState(end.position, end.logdensity, end.logdensity_grad)
        info = HMCInfo(
            acceptance_prob=accept_prob,
            is_accepted=accept,
            energy=energy1,
            is_divergent=is_divergent,
            num_integration_steps=n_steps,
        )
        return tree_where_bcast(accept, proposal, state), info

    return step


def init(position: Params, logdensity_fn: Callable) -> HMCState:
    """State at chain-batched ``position`` (leaves (C, ...)) from one chain's
    ``logdensity_fn``."""
    return batched_init(position, lift_value_and_grad(logdensity_fn))


def build_kernel(
    logdensity_fn: Callable,
    num_integration_steps: int,
    jitter_steps: bool = True,
    divergence_threshold: float = 1000.0,
    metric: Optional[Metric] = None,
):
    """Returns ``step(state, step_size, inv_mass, *, momentum=None,
    uniforms=None, jitter_uniforms=None, generator=None) -> (state, info)``
    for one chain's ``logdensity_fn`` (params dict -> scalar), run over the
    chain axis: state leaves are (C, ...), ``step_size`` is (C,), ``inv_mass``
    leaves are (C, ...), info fields are (C,).

    With ``jitter_steps`` a chain makes max(ceil(U(0,1) L), 1) leapfrog steps
    per draw, drawn per chain (``info.num_integration_steps``).

    ``metric``: an ops.metrics.Metric (chain-batched maps) that overrides the
    diagonal metric; the ``inv_mass`` argument is then ignored.
    """
    return _build_step(lift_value_and_grad(logdensity_fn), num_integration_steps,
                       divergence_threshold, None, jitter_steps, metric)


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
    return _build_step(value_and_grad_fn, num_integration_steps, divergence_threshold,
                       grad_fn, False, None)
