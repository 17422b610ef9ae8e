"""Stochastic-gradient MCMC over an explicit chain axis: SGLD (Welling & Teh
2011) and SGHMC with friction (Chen, Fox & Guestrin 2014) as minibatch
kernels, and the loop that runs them.

Every state carries a leading chain axis C (``run_sgmcmc`` is the C = 1
case of ``run_sgmcmc_chains``).  The dataset lives on the device; each step
gathers one random minibatch per chain by index (``X[idx]`` with ``idx``
(C, B) is (C, B, D)).  ``run_sgmcmc_chains`` is a host loop that enqueues
and never reads back: the step counter, the step size and the log density
stay on the device and kept positions go into preallocated (C, T, ...)
buffers.

Every random number of a step can be injected as one ``SGMCMCDraws``;
otherwise it comes from the explicit ``generator``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, NamedTuple, Optional, Tuple

import torch

from ..ops import streams
from ..ops.tree import Params, tree_batch_randn_like, tree_batch_ravel, tree_zeros_like
from ..utils import profiling

Batch = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# Step-size schedules: t is a 0-d tensor (the running step count, on the
# device), and so is the step size
# ---------------------------------------------------------------------------


def inverse_time_decay(initial_step_size: float, decay: Optional[float] = None):
    """eps_t = eps_0 / (1 + decay * t), with decay defaulting to eps_0."""
    if decay is None:
        decay = initial_step_size

    def schedule(t):
        return initial_step_size / (1.0 + decay * t)

    return schedule


def constant_schedule(step_size: float):
    made = {}

    def schedule(t):
        device = t.device if isinstance(t, torch.Tensor) else torch.device("cpu")
        if device not in made:     # one fill per device, not one per step
            made[device] = torch.full((), step_size, dtype=torch.float32, device=device)
        return made[device]

    return schedule


def polynomial_decay(a: float, b: float, gamma: float = 0.55):
    """Welling-Teh polynomial schedule eps_t = a (b + t)^-gamma."""

    def schedule(t):
        return a * (b + t) ** (-gamma)

    return schedule


# ---------------------------------------------------------------------------
# States, info, draws
# ---------------------------------------------------------------------------


class SGLDState(NamedTuple):
    position: Params
    logdensity: torch.Tensor   # (C,) minibatch-scaled log posterior at the last step


class SGHMCState(NamedTuple):
    position: Params
    momentum: Params
    logdensity: torch.Tensor


class SGMCMCInfo(NamedTuple):
    logdensity: torch.Tensor
    step_size: torch.Tensor


class SGMCMCDraws(NamedTuple):
    """Every random number of one step.

    ``indices``: the run loop's minibatch rows, (C, B) (the kernels do not read
    it).  ``noise``: one standard-normal dict (leaves (C, ...)) per gradient
    step: one for SGLD, ``num_leapfrog`` for SGHMC.  ``momentum``: SGHMC's
    refreshed momentum, when it refreshes.  ``masks``: for a keyed log
    density, one mask set per gradient step and, for SGHMC, one more for the
    final value."""

    indices: Optional[torch.Tensor] = None
    noise: Tuple[Params, ...] = ()
    momentum: Optional[Params] = None
    masks: Tuple[Any, ...] = ()


def _as_scalar(x, like: Params) -> torch.Tensor:
    """A step size (a float or a 0-d tensor) as a 0-d tensor beside the state."""
    leaf = next(iter(like.values()))
    return torch.as_tensor(x, dtype=torch.float32, device=leaf.device)


def _chain_zeros(position: Params) -> torch.Tensor:
    leaf = next(iter(position.values()))
    return torch.zeros((leaf.shape[0],), dtype=torch.float32, device=leaf.device)


def sgld_init(position: Params) -> SGLDState:
    """State at chain-batched ``position`` (leaves (C, ...))."""
    return SGLDState(position, _chain_zeros(position))


def sghmc_init(position: Params) -> SGHMCState:
    return SGHMCState(position, tree_zeros_like(position), _chain_zeros(position))


def _make_vag(logdensity_fn, keyed, value_and_grad_fn):
    """The kernels' gradient source and its value alone:
    ``vag(position, batch, masks | None) -> ((C,) values, grads)`` and
    ``value(position, batch, masks | None) -> (C,) values``.

    ``logdensity_fn(params, batch[, masks])`` marked ``chain_batched`` (the
    models' ``make_batched_logdensity``) is called once on all chains, with
    the batch as the run loop gathered it, and differentiated by one
    ``autograd.grad`` of the sum over chains.  Any other function is one
    chain's (params dict -> scalar) and goes through ``vmap`` over the chain
    axis of the params, the batch (per-chain rows) and the masks.

    ``value_and_grad_fn`` overrides both: the hook through which a
    data-parallel path supplies a value and gradient already summed over its
    data shards."""
    if value_and_grad_fn is not None:
        return value_and_grad_fn, lambda q, b, m: value_and_grad_fn(q, b, m)[0]

    def call(q, b, m):
        return logdensity_fn(q, b, m) if keyed else logdensity_fn(q, b)

    if getattr(logdensity_fn, "chain_batched", False):
        def vag(q, b, m):
            keys = list(q)
            with torch.enable_grad():
                leaves = [q[k].detach().requires_grad_(True) for k in keys]
                value = call(dict(zip(keys, leaves)), b, m)
                grads = torch.autograd.grad(value.sum(), leaves)
            return value.detach(), dict(zip(keys, grads))

        def value_fn(q, b, m):
            with torch.no_grad():
                return call(q, b, m)

        return vag, value_fn

    in_dims = (0, 0, 0 if keyed else None)
    lifted = torch.func.vmap(torch.func.grad_and_value(call), in_dims=in_dims)

    def vag(q, b, m):
        grad, value = lifted(q, b, m)
        return value, grad

    return vag, torch.func.vmap(call, in_dims=in_dims)


def _mask_fn(logdensity_fn, keyed, value_and_grad_fn):
    """``draw_masks(position, batch, generator)`` of a keyed density."""
    if not keyed:
        return None
    source = value_and_grad_fn if value_and_grad_fn is not None else logdensity_fn
    if not hasattr(source, "draw_masks"):
        raise ValueError("keyed=True needs a log density that carries draw_masks(params, "
                         "batch, generator), as DropoutMLP.make_batched_logdensity("
                         "dropout=True) does")
    return source.draw_masks


# ---------------------------------------------------------------------------
# SGLD
# ---------------------------------------------------------------------------


def build_sgld_kernel(logdensity_fn: Callable = None, temperature: float = 1.0,
                      keyed: bool = False, value_and_grad_fn: Callable = None):
    """Returns ``step(state, batch, step_size, *, draws=None, generator=None)
    -> (state, info)``.

    theta <- theta + (eps / 2) grad log p_hat(theta) + N(0, eps * T)

    keyed=True: ``logdensity_fn`` takes (params, batch, masks): the
    dropout-MLP potential.  One fresh mask set per step, distinct per chain,
    serves the value and the gradient of that step alike.

    ``value_and_grad_fn``: optional (params, batch, masks | None) -> (value,
    grad) override, the data-parallel composition point (see ``_make_vag``)."""
    vag, _ = _make_vag(logdensity_fn, keyed, value_and_grad_fn)
    draw_masks = _mask_fn(logdensity_fn, keyed, value_and_grad_fn)

    def draw(state: SGLDState, batch: Batch, generator: torch.Generator) -> SGMCMCDraws:
        masks = (draw_masks(state.position, batch, generator),) if keyed else ()
        return SGMCMCDraws(noise=(tree_batch_randn_like(state.position, generator),),
                           masks=masks)

    def step(state: SGLDState, batch: Batch, step_size, *,
             draws: Optional[SGMCMCDraws] = None,
             generator: Optional[torch.Generator] = None):
        if draws is None:
            draws = draw(state, batch, generator)
        step_size = _as_scalar(step_size, state.position)
        value, grad = vag(state.position, batch, draws.masks[0] if keyed else None)
        half, sigma = 0.5 * step_size, (step_size * temperature) ** 0.5
        # the update on all leaves side by side: one launch per term, not one
        # per leaf (the step is bound by the host's launches)
        q, unravel = tree_batch_ravel(state.position)
        g, noise = tree_batch_ravel(grad)[0], tree_batch_ravel(draws.noise[0])[0]
        q = torch.addcmul(torch.addcmul(q, g, half), noise, sigma)
        return SGLDState(unravel(q), value), SGMCMCInfo(value, step_size)

    step.draw = draw
    return step


# ---------------------------------------------------------------------------
# SGHMC
# ---------------------------------------------------------------------------


def build_sghmc_kernel(logdensity_fn: Callable = None, friction: float = 1.0,
                       temperature: float = 1.0, num_leapfrog: int = 1,
                       refresh_momentum: bool = False, keyed: bool = False,
                       value_and_grad_fn: Callable = None):
    """Returns ``step(state, batch, step_size, *, draws=None, generator=None)
    -> (state, info)``.

    Per inner step (v is the momentum, unit mass):
      v <- (1 - friction * eps) v + eps grad log p_hat(q) + N(0, 2 friction eps T)
      q <- q + eps v

    refresh_momentum=False keeps the momentum across steps (the published
    dynamics: friction and noise alone give the stationary distribution);
    True resamples v ~ N(0, I) at each outer step.

    keyed=True: a distinct mask set per inner step, and a fresh one, used by
    no inner step, for the final value that becomes ``state.logdensity``."""
    vag, value_fn = _make_vag(logdensity_fn, keyed, value_and_grad_fn)
    draw_masks = _mask_fn(logdensity_fn, keyed, value_and_grad_fn)

    def draw(state: SGHMCState, batch: Batch, generator: torch.Generator) -> SGMCMCDraws:
        q = state.position
        with profiling.span("sghmc.draw"):
            return SGMCMCDraws(
                noise=tuple(tree_batch_randn_like(q, generator) for _ in range(num_leapfrog)),
                momentum=tree_batch_randn_like(q, generator) if refresh_momentum else None,
                masks=tuple(draw_masks(q, batch, generator)
                            for _ in range(num_leapfrog + 1)) if keyed else ())

    def step(state: SGHMCState, batch: Batch, step_size, *,
             draws: Optional[SGMCMCDraws] = None,
             generator: Optional[torch.Generator] = None):
        if draws is None:
            draws = draw(state, batch, generator)
        # spans: sghmc.update around the state's ravels and again around each
        # inner step's update, sghmc.grad around each inner step's gradient
        with profiling.span("sghmc.update"):
            step_size = _as_scalar(step_size, state.position)
            damp = 1.0 - friction * step_size
            noise_scale = (2.0 * friction * temperature * step_size) ** 0.5
            # positions and momenta as (C, P) matrices, all leaves side by
            # side: one launch per term of the update, not one per leaf (the
            # step is bound by the host's launches); the log density sees
            # dict views
            q, unravel = tree_batch_ravel(state.position)
            v = tree_batch_ravel(draws.momentum if refresh_momentum else state.momentum)[0]
        for i in range(num_leapfrog):
            with profiling.span("sghmc.grad"):
                _, grad = vag(unravel(q), batch, draws.masks[i] if keyed else None)
            with profiling.span("sghmc.update"):
                g, noise = tree_batch_ravel(grad)[0], tree_batch_ravel(draws.noise[i])[0]
                v = torch.addcmul(torch.addcmul(damp * v, g, step_size), noise, noise_scale)
                q = torch.addcmul(q, v, step_size)
        with profiling.span("sghmc.value"):
            position = unravel(q)
            value = value_fn(position, batch, draws.masks[num_leapfrog] if keyed else None)
        return SGHMCState(position, unravel(v), value), SGMCMCInfo(value, step_size)

    step.draw = draw
    return step


# ---------------------------------------------------------------------------
# Minibatch run loop
# ---------------------------------------------------------------------------


def run_sgmcmc_chains(
    kernel: Callable,       # (state, batch, step_size, *, draws, generator) -> (state, info)
    initial_states,         # leaves with a leading chain axis
    num_chains: int,
    data: Batch,            # full dataset, tuple of tensors with leading axis N
    batch_size: int,
    num_steps: int,
    step_size_schedule: Callable,
    collect_every: int = 1,
    burnin_steps: int = 0,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Iterable[SGMCMCDraws]] = None,
):
    """``num_steps`` minibatch updates of every chain; every
    ``collect_every``-th position after ``burnin_steps`` is kept.  Each chain
    gathers its own minibatch, uniform rows with replacement.  The step size
    is the schedule's at the running step count t, which counts the burn-in
    steps too.

    ``draws``: one ``SGMCMCDraws`` (with ``indices``) per step, in place of
    the generator.

    Returns (final_states, positions, infos): positions leaves are
    (C, T, ...) with T = (num_steps - burnin_steps) // collect_every, the
    info fields (C, T).  Steps past the last kept draw are not run."""
    leaf = next(iter(initial_states.position.values()))
    if leaf.shape[0] != num_chains:
        raise ValueError(f"initial_states carry {leaf.shape[0]} chains, num_chains={num_chains}")
    device, n_data = leaf.device, data[0].shape[0]
    num_collected = max((num_steps - burnin_steps) // collect_every, 0)
    draws = iter(draws) if draws is not None else None

    state, t = initial_states, torch.zeros((), dtype=torch.float32, device=device)

    def one_step(state, t):
        given = next(draws) if draws is not None else None
        with profiling.span("sghmc.batch"):
            idx = given.indices if given is not None else streams.randint(
                0, n_data, (num_chains, batch_size), generator=generator, device=device)
            batch = tuple(d[idx] for d in data)
        state, info = kernel(state, batch, step_size_schedule(t), draws=given,
                             generator=generator)
        return state, t + 1.0, info

    for _ in range(burnin_steps):
        state, t, _ = one_step(state, t)

    positions = {k: v.new_empty((num_chains, num_collected) + v.shape[1:])
                 for k, v in state.position.items()}
    logdensity = leaf.new_empty((num_chains, num_collected))
    step_sizes = leaf.new_empty((num_collected,))
    for i in range(num_collected):
        for _ in range(collect_every):
            state, t, info = one_step(state, t)
        for k, v in state.position.items():
            positions[k][:, i] = v
        logdensity[:, i] = info.logdensity
        step_sizes[i] = info.step_size
    infos = SGMCMCInfo(logdensity, step_sizes.expand(num_chains, num_collected))
    return state, positions, infos


def run_sgmcmc(kernel: Callable, initial_state, data: Batch, **kwargs):
    """One chain: ``run_sgmcmc_chains`` with a chain axis of 1 (the state's
    leaves are (1, ...), and so are the results' leading axes)."""
    return run_sgmcmc_chains(kernel, initial_state, 1, data, **kwargs)
