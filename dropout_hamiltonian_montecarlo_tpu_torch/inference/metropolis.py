"""Random-walk Metropolis-Hastings over an explicit chain axis.

Gaussian random-walk proposals with a random per-step log-uniform scale
factor, an MH accept on the log-density difference, burn-in scale tuning by
acceptance-rate bands, and a coordinate-wise mode (one uniformly chosen
coordinate moves per step, as a one-hot mask).  Every state carries a
leading chain axis C; each chain has its own draws and its own scale.

Every random number of a step can be injected (``draws=MHDraws(...)``);
otherwise the set is drawn from ``generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import streams
from ..ops.integrators import lift_value
from ..ops.tree import Params, tree_batch_ravel, tree_where_bcast


class MHState(NamedTuple):
    position: Params
    logdensity: torch.Tensor


class MHInfo(NamedTuple):
    acceptance_prob: torch.Tensor
    is_accepted: torch.Tensor


class MHDraws(NamedTuple):
    """Every random number of one step.  ``noise`` is standard normal in the
    flat layout of ``ops.tree.tree_batch_ravel``; a coordinate-wise step uses
    its first column only."""
    log_factor: torch.Tensor       # (C,) uniform on [-1, 1): the scale jitter
    noise: torch.Tensor            # (C, D)
    coordinate: torch.Tensor       # (C,) int64 in [0, D)
    accept_uniform: torch.Tensor   # (C,)


def sample_draws(num_chains: int, dim: int, generator: torch.Generator, device,
                 dtype=torch.float32) -> MHDraws:
    """A step's draws from ``generator``."""
    if generator is None:
        raise ValueError("pass draws= or an explicit generator=")
    f = dict(generator=generator, device=device)
    return MHDraws(
        log_factor=2.0 * streams.rand((num_chains,), dtype=dtype, **f) - 1.0,
        noise=streams.randn((num_chains, dim), dtype=dtype, **f),
        coordinate=streams.randint(0, dim, (num_chains,), **f),
        accept_uniform=streams.rand((num_chains,), dtype=dtype, **f),
    )


def init(position: Params, logdensity_fn: Callable) -> MHState:
    """State at chain-batched ``position`` (leaves (C, ...)) from one chain's
    ``logdensity_fn``."""
    return MHState(position, lift_value(logdensity_fn)(position))


def build_kernel(logdensity_fn: Callable, jitter_scale: bool = True,
                 coordinate_wise: bool = False):
    """Returns ``step(state, scale, *, draws=None, generator=None) ->
    (state, info)`` for one chain's ``logdensity_fn``, run over the chain
    axis; ``scale`` is a float or a per-chain (C,) vector.

    With ``jitter_scale`` each step multiplies a chain's proposal scale by
    exp(U(-1, 1)), which helps on multi-scale targets.  With
    ``coordinate_wise`` each step perturbs exactly one uniformly chosen
    coordinate of each chain.
    """
    batched_logdensity = lift_value(logdensity_fn)

    def step(state: MHState, scale, *, draws: Optional[MHDraws] = None,
             generator: Optional[torch.Generator] = None):
        flat, unravel = tree_batch_ravel(state.position)            # (C, D)
        if draws is None:
            draws = sample_draws(flat.shape[0], flat.shape[1], generator, flat.device,
                                 flat.dtype)
        eff_scale = torch.as_tensor(scale, dtype=flat.dtype, device=flat.device)
        if jitter_scale:
            eff_scale = eff_scale * torch.exp(draws.log_factor)
        if coordinate_wise:
            one_hot = torch.arange(flat.shape[1], device=flat.device) == draws.coordinate[:, None]
            noise = torch.where(one_hot, draws.noise[:, :1], 0.0)
        else:
            noise = draws.noise
        proposal = unravel(flat + eff_scale[..., None] * noise)
        proposal_logdensity = batched_logdensity(proposal)

        delta = proposal_logdensity - state.logdensity
        delta = torch.where(torch.isnan(delta), -float("inf"), delta)
        accept_prob = torch.clamp(torch.exp(delta), max=1.0)
        accept = draws.accept_uniform < accept_prob
        new_state = tree_where_bcast(accept, MHState(proposal, proposal_logdensity), state)
        return new_state, MHInfo(accept_prob, accept)

    return step


def tune_scale(scale: torch.Tensor, acceptance_rate: torch.Tensor) -> torch.Tensor:
    """Acceptance-band scale tuning, the first matching band of
      <0.001: x0.1, <0.05: x0.5, <0.2: x0.9, >0.95: x10, >0.75: x2, >0.5: x1.1
    and x1 otherwise, per chain."""
    r = torch.as_tensor(acceptance_rate)
    factor = torch.ones_like(r)
    for cond, value in reversed([(r < 0.001, 0.1), (r < 0.05, 0.5), (r < 0.2, 0.9),
                                 (r > 0.95, 10.0), (r > 0.75, 2.0), (r > 0.5, 1.1)]):
        factor = torch.where(cond, value, factor)
    return scale * factor


def run_warmup_scale(kernel, state: MHState, num_steps: int, initial_scale,
                     tune_interval: int = 100, *,
                     generator: Optional[torch.Generator] = None):
    """Burn-in with a scale tuning every ``tune_interval`` steps, on each
    chain's own acceptance rate.  Returns (state, (C,) scales)."""
    scale = torch.as_tensor(initial_scale, dtype=state.logdensity.dtype,
                            device=state.logdensity.device).expand(state.logdensity.shape)
    for _ in range(max(num_steps // tune_interval, 1)):
        accepts = []
        for _ in range(tune_interval):
            state, info = kernel(state, scale, generator=generator)
            accepts.append(info.is_accepted)
        scale = tune_scale(scale, torch.stack(accepts).to(torch.float32).mean(dim=0))
    return state, scale
