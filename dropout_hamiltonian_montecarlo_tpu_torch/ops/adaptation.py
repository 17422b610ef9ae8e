"""Warmup adaptation, per chain: dual-averaging step size (Hoffman & Gelman
2014), a Welford accumulator for the diagonal inverse mass, and the
reasonable-step-size search (their Algorithm 4)."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .integrators import IntegratorState, lift_value_and_grad, velocity_verlet_batched
from .tree import Params, tree_zeros_like


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor        # current log eps
    log_step_avg: torch.Tensor    # running averaged log eps (the final answer)
    gradient_avg: torch.Tensor    # H-bar: running avg of (target - accept_prob)
    count: torch.Tensor           # t
    mu: torch.Tensor              # shrinkage target log(10 * eps0)


def dual_averaging_init(initial_step_size: torch.Tensor) -> DualAveragingState:
    """(C,) step sizes -> C independent per-chain states (a 0-d tensor gives
    one state)."""
    log_eps0 = torch.log(torch.as_tensor(initial_step_size, dtype=torch.float32))
    return DualAveragingState(
        log_step=log_eps0,
        log_step_avg=log_eps0,
        gradient_avg=torch.zeros_like(log_eps0),
        count=torch.zeros_like(log_eps0),
        mu=math.log(10.0) + log_eps0,
    )


def dual_averaging_update(
    state: DualAveragingState,
    accept_prob: torch.Tensor,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    """One Nesterov dual-averaging step (target 0.8, gamma 0.05, t0 10,
    kappa 0.75 by default)."""
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    grad_avg = (1.0 - w) * state.gradient_avg + w * (target - accept_prob)
    log_step = state.mu - (torch.sqrt(count) / gamma) * grad_avg
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, grad_avg, count, state.mu)


# ---------------------------------------------------------------------------
# Welford running variance -> diagonal inverse mass matrix
# ---------------------------------------------------------------------------


class WelfordState(NamedTuple):
    mean: Params     # leaves (C, ...): one accumulator per chain
    m2: Params
    count: float     # the chains share the window schedule, so one host count


def welford_init(position_like: Params) -> WelfordState:
    return WelfordState(tree_zeros_like(position_like), tree_zeros_like(position_like), 0.0)


def welford_update(state: WelfordState, sample: Params) -> WelfordState:
    count = state.count + 1.0
    delta = {k: sample[k] - state.mean[k] for k in sample}
    mean = {k: state.mean[k] + delta[k] / count for k in sample}
    m2 = {k: state.m2[k] + delta[k] * (sample[k] - mean[k]) for k in sample}
    return WelfordState(mean, m2, count)


def welford_inv_mass(state: WelfordState, regularize: bool = True) -> Params:
    """Posterior-variance estimate as M^-1, Stan-style shrinkage to unit."""
    n = state.count

    def var(m2: torch.Tensor) -> torch.Tensor:
        v = m2 / max(n - 1.0, 1.0)
        if regularize:
            v = (n / (n + 5.0)) * v + 1e-3 * (5.0 / (n + 5.0))
        return torch.clamp(v, min=1e-10)

    return {k: var(v) for k, v in state.m2.items()}


# ---------------------------------------------------------------------------
# find_reasonable_epsilon
# ---------------------------------------------------------------------------


def find_reasonable_step_size(
    logdensity_fn: Callable,
    metric,
    position: Params,
    initial_step_size: float = 1.0,
    max_doublings: int = 30,
    *,
    momentum: Optional[Params] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Algorithm 4 of Hoffman & Gelman (2014) for every chain at once:
    double or halve each chain's step size until its one-step acceptance
    probability crosses 0.5, at most ``max_doublings`` times.  A chain that
    has crossed keeps its step size (a masked select) while the others go on.

    ``logdensity_fn`` is one chain's log density, ``position`` a
    chain-batched dict; the one momentum draw is injected (``momentum=``) or
    taken from ``generator``.  Returns the (C,) step sizes."""
    value_and_grad_fn = lift_value_and_grad(logdensity_fn)
    step_fn = velocity_verlet_batched(value_and_grad_fn, metric.kinetic_grad)
    value, grad = value_and_grad_fn(position)
    if momentum is None:
        momentum = metric.sample_momentum(position, generator)
    state0 = IntegratorState(position, momentum, value, grad)
    h0 = -value + metric.kinetic_energy(momentum)

    def log_accept(eps: torch.Tensor) -> torch.Tensor:
        s = step_fn(state0, eps)
        delta = h0 - (-s.logdensity + metric.kinetic_energy(s.momentum))
        return torch.where(torch.isfinite(delta), delta, -float("inf"))

    eps = torch.full_like(value, float(initial_step_size))
    log_half = math.log(0.5)
    # direction: +1 where the accept prob is already above 0.5, else -1
    direction = torch.where(log_accept(eps) > log_half, 1.0, -1.0).to(eps.dtype)
    for _ in range(max_doublings):
        searching = direction * log_accept(eps) > direction * log_half     # not crossed
        if not bool(searching.any()):
            break
        eps = torch.where(searching, eps * torch.pow(2.0, direction), eps)
    return eps
