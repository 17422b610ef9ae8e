"""Warmup: per-chain dual-averaging step-size adaptation."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ops.adaptation import dual_averaging_init, dual_averaging_update
from ..ops.tree import Params, tree_ones_like


class WarmupResult(NamedTuple):
    state: Any                 # final sampler state
    step_size: torch.Tensor    # adapted step size (exp of the averaged log step)
    inv_mass: Params           # inverse mass (the initial one: no mass adaptation)
    info: Any                  # (per-step info stacked over steps, step sizes (T, C))


def run_warmup(
    kernel: Callable,
    initial_state,
    num_steps: int,
    initial_step_size,
    target_acceptance: float = 0.8,
    initial_inv_mass: Optional[Params] = None,
    adapt_mass: bool = True,
    generator: Optional[torch.Generator] = None,
) -> WarmupResult:
    """Run ``num_steps`` kernel steps, adapting the (per-chain) step size by
    dual averaging.  ``kernel(state, step_size, inv_mass, generator=...)``
    returns (state, info) with ``info.acceptance_prob``.

    Only ``adapt_mass=False`` is ported: dual averaging alone, the inverse
    mass stays at its initial value (the right choice for a target already
    whitened by a Gauss-Newton metric).
    """
    if adapt_mass:
        raise NotImplementedError(
            "adapt_mass=True (Welford mass windows) is not ported yet: see "
            "ROADMAP.md, queue 1, 'Welford and the window schedule'")
    if initial_inv_mass is None:
        initial_inv_mass = tree_ones_like(initial_state.position)

    da = dual_averaging_init(initial_step_size)
    state = initial_state
    infos, step_sizes = [], []
    for _ in range(int(num_steps)):
        step_size = torch.exp(da.log_step)
        state, info = kernel(state, step_size, initial_inv_mass,
                             generator=generator)
        da = dual_averaging_update(da, info.acceptance_prob, target_acceptance)
        infos.append(info)
        step_sizes.append(step_size)

    if infos:
        stacked = type(infos[0])(*(torch.stack(f) for f in zip(*infos)))
        sizes = torch.stack(step_sizes)
    else:
        stacked, sizes = None, None
    return WarmupResult(state, torch.exp(da.log_step_avg), initial_inv_mass,
                        (stacked, sizes))
