"""The sampling loop: run any kernel for a number of draws and collect them."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


def _stack(items):
    """A list of equal NamedTuples of tensors and dicts -> one, stacked on a
    new leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: torch.stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(f)) for f in zip(*items)))
    return torch.stack(items)


def run_inference(
    kernel: Callable,
    initial_state,
    num_samples: int,
    thin: int = 1,
    *,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Any, Any]:
    """Run ``kernel(state, generator=...) -> (state, info)`` for num_samples
    draws.

    Returns (final_state, (stacked_states, stacked_infos)) where the stacked
    tensors have a leading draw axis (the chain axis comes second).  With
    thin > 1 only every thin-th draw is kept."""
    state = initial_state
    states, infos = [], []
    for _ in range(int(num_samples)):
        for _ in range(thin - 1):
            state, _ = kernel(state, generator=generator)
        state, info = kernel(state, generator=generator)
        states.append(state)
        infos.append(info)
    if not states:
        return state, (None, None)
    return state, (_stack(states), _stack(infos))


def posterior_dict(states, position_attr: str = "position"):
    """The stacked positions dict of stacked states."""
    return getattr(states, position_attr)
