"""Stan-style window adaptation for HMC/NUTS, per chain.

  [ fast: DA only | middle: DA + Welford windows (doubling) | fast: DA only ]

The schedule is computed on the host and is the same for every chain; the
statistics (dual-averaging state, Welford mean and m2, inverse mass) are per
chain.  At the end of each middle window the diagonal inverse mass is
refreshed from the Welford accumulator, the accumulator resets, and dual
averaging restarts from the current averaged step size.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.adaptation import (dual_averaging_init, dual_averaging_update, welford_init,
                              welford_inv_mass, welford_update)
from ..ops.tree import Params, tree_ones_like


def build_schedule(num_steps: int, init_buffer: int = 75, term_buffer: int = 50,
                   first_window: int = 25):
    """(is_middle, window_end) boolean arrays of length num_steps."""
    num_steps = int(num_steps)
    if num_steps < 20:
        return (np.zeros(num_steps, bool), np.zeros(num_steps, bool))
    # shrink buffers for short warmups, as Stan does
    if init_buffer + term_buffer + first_window > num_steps:
        frac = num_steps / (init_buffer + term_buffer + first_window)
        init_buffer = int(init_buffer * frac)
        term_buffer = int(term_buffer * frac)
        first_window = max(num_steps - init_buffer - term_buffer, 1)

    is_middle = np.zeros(num_steps, bool)
    window_end = np.zeros(num_steps, bool)
    is_middle[init_buffer: num_steps - term_buffer] = True

    # doubling windows inside the middle phase
    pos = init_buffer
    size = first_window
    while pos < num_steps - term_buffer:
        end = pos + size
        if end + 2 * size > num_steps - term_buffer:
            end = num_steps - term_buffer
        window_end[min(end, num_steps) - 1] = True
        pos = end
        size *= 2
    return is_middle, window_end


class WarmupResult(NamedTuple):
    state: Any                 # final sampler state
    step_size: torch.Tensor    # adapted step size (exp of the averaged log step)
    inv_mass: Params           # adapted diagonal inverse mass
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
    dual averaging and, with ``adapt_mass``, the diagonal inverse mass by
    Welford windows.  ``kernel(state, step_size, inv_mass, generator=...)``
    returns (state, info) with ``info.acceptance_prob``.

    ``adapt_mass=False``: dual averaging only, the inverse mass stays at its
    initial value: the right choice for a target already whitened by a
    Gauss-Newton metric, where variance estimates from short windows are
    noisier than the known unit scale and drag the step size down.
    """
    if initial_inv_mass is None:
        initial_inv_mass = tree_ones_like(initial_state.position)
    num_steps = int(num_steps)
    if adapt_mass:
        is_middle, window_end = build_schedule(num_steps)
    else:
        is_middle = window_end = np.zeros(num_steps, bool)

    da = dual_averaging_init(initial_step_size)
    wf = welford_init(initial_state.position)
    inv_mass = initial_inv_mass
    state = initial_state
    infos, step_sizes = [], []
    for t in range(num_steps):
        step_size = torch.exp(da.log_step)
        state, info = kernel(state, step_size, inv_mass, generator=generator)
        da = dual_averaging_update(da, info.acceptance_prob, target_acceptance)
        infos.append(info)
        step_sizes.append(step_size)

        if is_middle[t]:
            wf = welford_update(wf, state.position)
        if window_end[t]:
            inv_mass = welford_inv_mass(wf)
            wf = welford_init(initial_state.position)
            # every field restarts; mu and log_step take the averaged log
            # step itself, not its round trip through exp and log
            da = dual_averaging_init(torch.exp(da.log_step_avg))._replace(
                mu=math.log(10.0) + da.log_step_avg, log_step=da.log_step_avg)

    if infos:
        stacked = type(infos[0])(*(torch.stack(f) for f in zip(*infos)))
        sizes = torch.stack(step_sizes)
    else:
        stacked, sizes = None, None
    return WarmupResult(state, torch.exp(da.log_step_avg), inv_mass, (stacked, sizes))
