"""Per-chain dual-averaging step-size adaptation (Hoffman & Gelman 2014)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


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
