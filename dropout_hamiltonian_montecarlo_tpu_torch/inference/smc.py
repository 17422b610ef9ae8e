"""Adaptive tempered Sequential Monte Carlo with systematic resampling.

- the particles are a dict with leading axis N, which is the chain axis of
  the mutation kernels: one device holds them all, or each rank a block;
- the temperature ladder lambda: 0 -> 1 is adapted so that the effective
  sample size of the incremental weights stays at target_ess * N (bisection
  on the device);
- mutation: any ``(state, step_size, inv_mass, *, generator)`` kernel of this
  package (HMC, NUTS, Metropolis) at the current tempered density, or
  minibatch SGHMC on the tempered potential (``mutation="sghmc"``);
- resampling: systematic (low-variance), one sorted-uniform gather.

The stage loop runs on the host and reads ``lmbda`` once a stage (its stop
test); nothing else inside a stage is read back.  The tempered density closes
over ``lmbda`` as a device scalar, so the mutation kernel is built once.

Particle sharding (``layout=``): each rank holds a block of the particles and
mutates it with a generator that carries the block (``ops/streams.py``), so
its draws are the one-process run's rows.  A stage all-gathers the particles'
log likelihoods and log weights (2 N floats) and runs the ladder step, the
ESS, the evidence increment and the systematic resampler on the global
vectors, the one-process code on the same numbers on every rank; then one
all-gather of the particles, from which each rank takes its block's parents.
The mutation's acceptance is gathered too and averaged as in one process.  So
a run on one rank is the one-process run, bit for bit, and on several ranks it
differs only where a block's arithmetic rounds otherwise than the full batch's.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import streams
from ..ops.integrators import lift_value
from ..ops.tree import Params, tree_ones_like
from .sgmcmc import SGMCMCDraws, build_sghmc_kernel, sghmc_init


def _block_rows(given, block):
    """One round's injected draws (HMC keyword draws or ``SGMCMCDraws``) at
    the rows of a particle block: every tensor with a particle axis is cut,
    the shared minibatch ``indices`` are not."""
    def cut(tree):
        if isinstance(tree, torch.Tensor):
            return tree[block.start:block.stop]
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*map(cut, tree)) if hasattr(tree, "_fields") else tuple(
                map(cut, tree))
        return tree

    if isinstance(given, SGMCMCDraws):
        return given._replace(noise=cut(given.noise), momentum=cut(given.momentum),
                              masks=cut(given.masks))
    return cut(given)


class SMCState(NamedTuple):
    particles: Params            # leading axis = num_particles
    log_weights: torch.Tensor    # (N,) unnormalised
    lmbda: torch.Tensor          # current inverse temperature in [0, 1]
    log_evidence: torch.Tensor   # accumulated log normalising-constant estimate


class SMCInfo(NamedTuple):
    lmbda: torch.Tensor
    ess: torch.Tensor
    acceptance: torch.Tensor
    num_stages: torch.Tensor
    # per-stage traces, (max_stages,), NaN past num_stages:
    stage_lmbda: Optional[torch.Tensor] = None
    stage_ess: Optional[torch.Tensor] = None
    stage_acceptance: Optional[torch.Tensor] = None
    stage_step_size: Optional[torch.Tensor] = None


class SMCDraws(NamedTuple):
    """Every random number of one stage: the resampler's offset ``u0`` (in
    [0, 1/N)) and one entry per mutation round: for the HMC mutation the
    kernel's keyword draws (``{"momentum": ..., "uniforms": ...,
    "jitter_uniforms": ...}``), for SGHMC an ``SGMCMCDraws`` whose
    ``indices`` (B,) pick the round's shared minibatch."""

    u0: torch.Tensor
    rounds: Sequence[Any]


def init(particles: Params) -> SMCState:
    leaf = next(iter(particles.values()))
    f32 = dict(dtype=torch.float32, device=leaf.device)
    return SMCState(particles=particles, log_weights=torch.zeros((leaf.shape[0],), **f32),
                    lmbda=torch.zeros((), **f32), log_evidence=torch.zeros((), **f32))


def ess_from_log_weights(log_w: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(log_w, dim=0)
    return 1.0 / (w * w).sum()


def systematic_resample(log_weights: torch.Tensor, *, u0: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Systematic resampling: (N,) parent indices.  ``u0``, the offset in
    [0, 1/N), can be injected."""
    n = log_weights.shape[0]
    cum = torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)
    if u0 is None:
        if generator is None:
            raise ValueError("pass u0= or an explicit generator=")
        # one offset for all particles: no particle axis, the same on every block
        u0 = streams.rand((), generator=generator, device=cum.device,
                          chain_axis=None) * (1.0 / n)
    points = u0 + torch.arange(n, dtype=torch.float32, device=cum.device) / n
    # cum[-1] can round below 1 in float32: a point past it clips to the last
    # particle, as an out-of-range gather index does in the JAX package
    return torch.clamp(torch.searchsorted(cum, points), max=n - 1)


def _solve_next_lambda(loglik: torch.Tensor, log_weights: torch.Tensor, lmbda: torch.Tensor,
                       target_ess: float, num_bisect: int = 30) -> torch.Tensor:
    """Largest lambda' in (lmbda, 1] with ESS(incremental weights) >=
    target_ess * N, by bisection (monotone in lambda'), on the device."""
    target = target_ess * loglik.shape[0]

    def ess_at(lam):
        return ess_from_log_weights(log_weights + (lam - lmbda) * loglik)

    one = torch.ones_like(lmbda)
    lo, hi = lmbda, one
    for _ in range(num_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(ess_at(one) >= target, one, lo)


def run_tempered_smc(
    initial_particles: Params,
    log_prior_fn: Callable[[Params], torch.Tensor],
    log_likelihood_fn: Callable[[Params], torch.Tensor],
    kernel_builder: Callable[[Callable], Callable] = None,
    # kernel_builder(logdensity_fn) -> (state, step_size, inv_mass, *, generator) step
    init_builder: Callable[[Callable], Callable] = None,
    # init_builder(logdensity_fn) -> (positions) -> state
    step_size: float = 0.1,
    num_mcmc_steps: int = 5,
    target_ess: float = 0.5,
    max_stages: int = 100,
    adapt_step_size: bool = True,
    target_mutation_accept: float = 0.7,
    mutation: str = "hmc",
    log_likelihood_batch_fn: Callable = None,
    data: Optional[Tuple[torch.Tensor, ...]] = None,
    batch_size: Optional[int] = None,
    sghmc_friction: float = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[SMCDraws]] = None,
    layout=None,
) -> Tuple[SMCState, SMCInfo]:
    """Adaptive tempered SMC from the prior sample to the posterior.

    ``log_prior_fn`` and ``log_likelihood_fn`` map ONE particle's dict to a
    scalar, or, marked ``chain_batched``, the whole particle dict to (N,)
    values.  The mutation kernel at temperature lambda targets log_prior +
    lambda * log_likelihood.

    adapt_step_size=True: the mutation step size is retuned every stage from
    the PREVIOUS stage's mean acceptance, eps' = eps * exp(acc - target): as
    the temperature rises the tempered posterior sharpens by orders of
    magnitude and a fixed step collapses the late-stage acceptance.  The
    per-stage traces (lambda, incremental-weight ESS, acceptance, the step
    size used in the stage) come back NaN-padded in ``SMCInfo``.

    mutation="sghmc": minibatch SGHMC on the tempered potential log_prior +
    lambda * (data_size / batch_size) * log_lik_batch; pass
    ``log_likelihood_batch_fn(params, batch)``, ``data`` and ``batch_size``.
    One shared minibatch per round serves every particle.  SGHMC has no MH
    accept, so the stage acceptance is NaN and the step size is not adapted.

    ``draws``: one ``SMCDraws`` per stage in place of the generator (their
    tensors at the GLOBAL particle count under ``layout``).

    ``layout``: a ``parallel.RankLayout`` whose chains axis carries the
    particles (see the module docstring).  ``initial_particles`` are then
    this rank's block, the generator carries
    ``parallel.chain_block(layout, N)``, and the returned state holds the
    block (its log evidence and lambda are global, the same on every rank)."""
    from ..parallel.mesh import all_gather_cat, chain_block, check_block

    state = init(initial_particles)
    n = state.log_weights.shape[0]
    device = state.log_weights.device
    f32 = dict(dtype=torch.float32, device=device)
    group = layout.chains_group if layout is not None else None
    block = None
    if group is not None:
        block = chain_block(layout, n * layout.num_chain_shards)
        if draws is None:
            check_block(generator, block)

    def gathered(t, dim=0):
        """Every particle's values of a per-particle tensor (particles on ``dim``)."""
        return t if group is None else all_gather_cat(t, group, dim=dim)
    if mutation not in ("hmc", "sghmc"):
        raise ValueError(f"unknown mutation {mutation!r}")
    if mutation == "hmc" and (kernel_builder is None or init_builder is None):
        missing = [name for name, v in (("kernel_builder", kernel_builder),
                                        ("init_builder", init_builder)) if v is None]
        raise ValueError(
            f"mutation='hmc' requires {' and '.join(missing)} (e.g. "
            f"kernel_builder=lambda ld: hmc.build_kernel(ld, num_steps), "
            f"init_builder=lambda ld: (lambda p: hmc.init(p, ld)))")
    if mutation == "sghmc" and (log_likelihood_batch_fn is None or data is None
                                or batch_size is None):
        raise ValueError("sghmc mutation needs log_likelihood_batch_fn, data and batch_size")

    # the stage's temperature, written in place each stage: the densities
    # below read it on the device, so the kernels are built once
    lam = torch.zeros((), **f32)
    batched = (getattr(log_prior_fn, "chain_batched", False)
               and getattr(log_likelihood_fn, "chain_batched", False))

    def logdensity(p):
        return log_prior_fn(p) + lam * log_likelihood_fn(p)

    logdensity.chain_batched = batched
    loglik_all = lift_value(log_likelihood_fn)

    if mutation == "hmc":
        kernel, init_fn = kernel_builder(logdensity), init_builder(logdensity)
        inv_mass = tree_ones_like(initial_particles)

        def mutate(particles, eps, rounds):
            states = init_fn(particles)
            accs = []
            for i in range(num_mcmc_steps):
                given = rounds[i] if rounds is not None else {"generator": generator}
                states, info = kernel(states, eps.expand(n), inv_mass, **given)
                accs.append(info.acceptance_prob)
            return states.position, gathered(torch.stack(accs), dim=1).mean()
    else:
        data_size = data[0].shape[0]
        scale = data_size / batch_size
        adapt_step_size = False
        batch_batched = batched and getattr(log_likelihood_batch_fn, "chain_batched", False)

        def tempered(p, b):
            return log_prior_fn(p) + lam * scale * log_likelihood_batch_fn(p, b)

        tempered.chain_batched = batch_batched
        kernel = build_sghmc_kernel(tempered, friction=sghmc_friction)

        def mutate(particles, eps, rounds):
            states = sghmc_init(particles)
            for i in range(num_mcmc_steps):
                given = rounds[i] if rounds is not None else None
                idx = given.indices if given is not None else streams.randint(
                    0, data_size, (batch_size,), generator=generator, device=device,
                    chain_axis=None)
                batch = tuple(d[idx] for d in data)
                if not batch_batched:     # one particle's density: vmapped over views
                    batch = tuple(b.expand((n,) + b.shape) for b in batch)
                states, _ = kernel(states, batch, eps, draws=given, generator=generator)
            return states.position, torch.full((), float("nan"), **f32)

    eps = torch.full((), float(step_size), **f32)
    acceptance = torch.zeros((), **f32)
    traces = torch.full((4, max_stages), float("nan"), **f32)   # lmbda, ess, acc, eps
    stages = 0
    while stages < max_stages and float(state.lmbda) < 1.0:     # the stage's one read
        given = draws[stages] if draws is not None else None
        rounds = given.rounds if given is not None else None
        if rounds is not None and block is not None:
            rounds = [_block_rows(r, block) for r in rounds]
        if group is None:
            loglik, prev_w = loglik_all(state.particles), state.log_weights
        else:
            # every particle's log likelihood and weight, on every rank
            loglik, prev_w = gathered(torch.stack([loglik_all(state.particles),
                                                   state.log_weights], dim=1)).unbind(1)
        new_lmbda = _solve_next_lambda(loglik, prev_w, state.lmbda, target_ess)
        log_w = prev_w + (new_lmbda - state.lmbda) * loglik
        stage_ess = ess_from_log_weights(log_w)
        # evidence increment, before the weights are reset by the resampling
        log_evidence = state.log_evidence + (torch.logsumexp(log_w, dim=0)
                                             - torch.logsumexp(prev_w, dim=0))

        idx = systematic_resample(log_w, u0=given.u0 if given is not None else None,
                                  generator=generator)
        if block is None:
            particles = {k: v[idx] for k, v in state.particles.items()}
        else:
            # a block's parents may lie in any block
            idx = idx[block.start:block.stop]
            particles = {k: gathered(v)[idx] for k, v in state.particles.items()}

        lam.copy_(new_lmbda)
        particles, acceptance = mutate(particles, eps, rounds)

        traces[:, stages] = torch.stack([new_lmbda, stage_ess, acceptance, eps])
        if adapt_step_size:     # for the NEXT stage, from this stage's acceptance
            eps = torch.clamp(eps * torch.exp(acceptance - target_mutation_accept), 1e-8, 1e3)
        state = SMCState(particles, torch.zeros_like(state.log_weights), new_lmbda,
                         log_evidence)
        stages += 1

    info = SMCInfo(state.lmbda, ess_from_log_weights(gathered(state.log_weights)), acceptance,
                   torch.tensor(stages, dtype=torch.int32, device=device), *traces)
    return state, info
