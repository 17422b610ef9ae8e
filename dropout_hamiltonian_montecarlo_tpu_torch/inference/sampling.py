"""High-level sampling entry points over the chain axis.

``sample_posterior`` runs warmup and sampling for every chain at once (the
JAX package vmaps a per-chain program; here the chain axis is explicit and
every chain has its own draws, step size and inverse mass).  The streaming
forms sample in chunks and keep the draws on the device block by block
(``DeviceBackend``).  File backends, checkpoints, resume and chain sharding
are not ported yet (ROADMAP slice 5).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import torch

from ..ops.tree import Params, tree_ones_like, tree_randn_like
from .base import run_inference
from .warmup import run_warmup


class Posterior(NamedTuple):
    """Stacked draws and diagnostics info.

    positions: dict with leading axes (num_chains, num_samples, ...); the info
    fields are (num_chains, num_samples).
    """

    positions: Params
    infos: Any
    step_size: torch.Tensor
    inv_mass: Params
    final_state: Any


def _num_chains(positions: Params, num_chains: int) -> None:
    got = next(iter(positions.values())).shape[0]
    if got != num_chains:
        raise ValueError(f"initial_positions carry {got} chains, num_chains={num_chains}")


def _warm(init_fn, kernel, initial_positions, num_warmup, initial_step_size,
          target_acceptance, adapt_mass, generator):
    """(state, (C,) step sizes, inv_mass) after warmup (or without one)."""
    state = init_fn(initial_positions)
    step_size = torch.full_like(state.logdensity, float(initial_step_size))
    if num_warmup > 0:
        warm = run_warmup(kernel, state, num_warmup, initial_step_size=step_size,
                          target_acceptance=target_acceptance, adapt_mass=adapt_mass,
                          generator=generator)
        return warm.state, warm.step_size, warm.inv_mass
    return state, step_size, tree_ones_like(initial_positions)


def sample_posterior(
    init_fn: Callable,          # (chain-batched positions) -> state
    kernel: Callable,           # (state, step_size, inv_mass, *, generator) -> (state, info)
    initial_positions: Params,  # dict with a leading chain axis
    num_samples: int,
    num_warmup: int = 500,
    num_chains: int = 1,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    thin: int = 1,
    adapt_mass: bool = True,
    *,
    generator: torch.Generator,
) -> Posterior:
    """Warmup, then sampling, for all chains together.

    ``adapt_mass=False``: warmup adapts the step size only: the right choice
    when the kernel carries its own metric (whitened NUTS/HMC under the
    Kronecker Gauss-Newton metric), where the diagonal inv_mass argument is
    ignored anyway."""
    _num_chains(initial_positions, num_chains)
    state, step_size, inv_mass = _warm(init_fn, kernel, initial_positions, num_warmup,
                                       initial_step_size, target_acceptance, adapt_mass,
                                       generator)

    def fixed_kernel(s, generator):
        return kernel(s, step_size, inv_mass, generator=generator)

    final_state, (states, infos) = run_inference(fixed_kernel, state, num_samples, thin=thin,
                                                 generator=generator)
    # (draws, chains, ...) -> (chains, draws, ...)
    positions = {k: v.transpose(0, 1) for k, v in states.position.items()}
    infos = type(infos)(*(f.transpose(0, 1) for f in infos))
    return Posterior(positions, infos, step_size, inv_mass, final_state)


def stack_chains(position: Params, num_chains: int) -> Params:
    """Tile one chain's position dict into a leading chain axis."""
    return {k: v.expand((num_chains,) + v.shape).clone() for k, v in position.items()}


def init_chain_positions(init_params_fn: Callable, num_chains: int, jitter: float = 0.0, *,
                         generator: torch.Generator, device) -> Params:
    """Per-chain initial positions from a model's ``init_params(generator,
    device)``, optionally jittered by ``jitter`` * N(0, I): overdispersed
    starts make R-hat meaningful."""
    draws = [init_params_fn(generator, device) for _ in range(num_chains)]
    positions = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    if jitter > 0.0:
        noise = tree_randn_like(positions, generator)
        positions = {k: positions[k] + jitter * noise[k] for k in positions}
    return positions


class DeviceBackend:
    """Keeps every appended block (a dict of (chunk, C, ...) tensors, draws
    leading) where it lies, on the device; ``draws()`` joins them into
    (C, T, ...) tensors for the diagnostics."""

    def __init__(self):
        self.device_blocks: List[Params] = []

    def append(self, block: Params) -> None:
        self.device_blocks.append(block)

    def draws(self) -> Params:
        keys = self.device_blocks[0].keys()
        return {k: torch.cat([b[k] for b in self.device_blocks]).transpose(0, 1)
                for k in keys}


def _refuse_unported(backend, checkpoint_path, resume) -> None:
    if checkpoint_path is not None or resume:
        raise NotImplementedError(
            "checkpoint_path/resume: checkpoints are not ported yet (ROADMAP slice 5)")
    if not isinstance(backend, DeviceBackend):
        raise NotImplementedError(
            "only DeviceBackend is ported; file backends (io/backend.py) are not "
            "ported yet (ROADMAP slice 5)")


def sample_posterior_streaming(
    init_fn: Callable,
    kernel: Callable,
    initial_positions: Params,
    backend: DeviceBackend,
    num_samples: int,
    chunk_size: int = 100,
    num_warmup: int = 500,
    num_chains: int = 1,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    adapt_mass: bool = True,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    *,
    generator: torch.Generator,
):
    """Warm up once, then sample in chunks, appending each chunk's positions
    (chunk, C, ...), draws leading, to ``backend``.  Returns (final_states,
    step_size, inv_mass, num_appended)."""
    _refuse_unported(backend, checkpoint_path, resume)
    _num_chains(initial_positions, num_chains)
    states, step_sizes, inv_mass = _warm(init_fn, kernel, initial_positions, num_warmup,
                                         initial_step_size, target_acceptance, adapt_mass,
                                         generator)
    states, appended, _ = sample_batched_streaming(
        kernel, states, step_sizes, inv_mass, backend, num_samples=num_samples,
        chunk_size=chunk_size, generator=generator)
    return states, step_sizes, inv_mass, appended


def sample_batched_streaming(
    kernel: Callable,       # chain-batched: (state, (C,) eps, inv_mass, *, generator)
    states,                 # chain-batched state (leaves (C, ...))
    step_sizes: torch.Tensor,
    inv_mass: Params,
    backend: DeviceBackend,
    num_samples: int,
    chunk_size: int = 100,
    transform: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    mesh=None,
    *,
    generator: torch.Generator,
):
    """Sample ``num_samples`` draws in chunks of ``chunk_size``.

    Each chunk's positions (C, chunk, ...) go through ``transform`` (e.g.
    unwhitening back to parameter space) and are appended to ``backend``
    with draws leading.  Returns (final_states, num_appended,
    info_summaries): one entry per chunk, the kernel's info averaged over
    (chunk, chains) as floats (one host sync per chunk)."""
    _refuse_unported(backend, checkpoint_path, resume)
    if mesh is not None:
        raise NotImplementedError("mesh: chain sharding is not ported yet (ROADMAP slice 5)")

    appended = 0
    info_summaries = []
    while appended < num_samples:
        take = min(chunk_size, num_samples - appended)
        positions, infos = [], []
        for _ in range(take):
            states, info = kernel(states, step_sizes, inv_mass, generator=generator)
            positions.append(states.position)
            infos.append(info)
        pos = {k: torch.stack([p[k] for p in positions], dim=1) for k in positions[0]}
        if transform is not None:
            pos = transform(pos)
        backend.append({k: v.transpose(0, 1) for k, v in pos.items()})
        fields = [torch.stack(f).to(torch.float32).mean() for f in zip(*infos)]
        info_summaries.append(type(infos[0])(*torch.stack(fields).tolist()))
        appended += take
    return states, appended, info_summaries
