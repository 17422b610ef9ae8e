"""Mean-field variational inference (ADVI) baseline.

Gaussian mean-field q(theta) = N(mu, diag(exp(2 rho))), reparameterised ELBO
gradients, Adam written out on (mu, rho).  The variational state is one
distribution and carries no chain axis; the ``num_mc_samples``
reparameterised draws of a step form the chain axis on which the log density
is evaluated, all on one shared minibatch.  Posterior draws come from q, so
the output plugs into the same predictive utilities as the samplers.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import streams
from ..ops.tree import Params, tree_batch_ravel
from .sgmcmc import Batch


class MeanFieldState(NamedTuple):
    mu: Params
    rho: Params       # log std-dev, elementwise
    opt_mu: Params    # Adam first moment (mu)
    opt_rho: Params
    opt2_mu: Params   # Adam second moment
    opt2_rho: Params
    step: torch.Tensor


def init(position: Params, initial_log_std: float = -3.0) -> MeanFieldState:
    """q centred at one chain's ``position`` (leaves without a chain axis)."""
    def zeros():
        return {k: torch.zeros_like(v) for k, v in position.items()}

    leaf = next(iter(position.values()))
    rho = {k: torch.full_like(v, initial_log_std) for k, v in position.items()}
    return MeanFieldState(position, rho, zeros(), zeros(), zeros(), zeros(),
                          torch.zeros((), dtype=torch.float32, device=leaf.device))


def _gaussian_entropy(rho) -> torch.Tensor:
    """Entropy of the mean-field Gaussian with log std-devs ``rho`` (a dict,
    or all its leaves in one vector): sum of rho + 0.5 (1 + log 2 pi)."""
    halflog2pie = 0.5 * (1.0 + math.log(2.0 * math.pi))
    leaves = list(rho.values()) if isinstance(rho, dict) else [rho]
    return sum(r.sum() for r in leaves) + halflog2pie * sum(r.numel() for r in leaves)


def _ravel(tree: Params):
    """One distribution's dict -> (its leaves in one vector, the map from an
    (S, P) matrix back to a dict with leaves (S, ...))."""
    mat, batch_unravel = tree_batch_ravel({k: v[None] for k, v in tree.items()})
    return mat[0], batch_unravel


def _randn_draws(like: Params, num: int, generator: Optional[torch.Generator]) -> Params:
    # one distribution, no chain axis: the draws are the same on every block
    return {k: streams.randn((num,) + v.shape, generator=generator, dtype=v.dtype,
                             device=v.device, chain_axis=None) for k, v in like.items()}


def build_kernel(logdensity_fn: Callable[[Params, Batch], torch.Tensor],
                 num_mc_samples: int = 1, learning_rate: float = 1e-2, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
    """Returns ``step(state, batch, *, epsilons=None, generator=None) ->
    (state, loss)``.

    ELBO = E_q[log p(theta, data)] + H[q], estimated with ``num_mc_samples``
    reparameterised draws theta = mu + exp(rho) * epsilon; ``epsilons`` (leaves
    (num_mc_samples, ...)) can be injected.  The loss is the negative ELBO.
    ``logdensity_fn(params, batch)`` marked ``chain_batched`` sees all draws
    at once as a chain axis; any other function is one draw's and is vmapped."""
    if getattr(logdensity_fn, "chain_batched", False):
        batched = logdensity_fn
    else:
        batched = torch.func.vmap(logdensity_fn, in_dims=(0, None))

    def step(state: MeanFieldState, batch: Batch, *, epsilons: Optional[Params] = None,
             generator: Optional[torch.Generator] = None):
        # Every leaf of a field laid side by side in one vector: the draw, the
        # reparameterisation and Adam then take one launch each instead of
        # one per leaf (the step is bound by the host's launches, not by the
        # card).  The dicts handed to the log density and kept in the new
        # state are views into these vectors.
        mu, batch_unravel = _ravel(state.mu)
        rho = _ravel(state.rho)[0]

        def unravel(z):
            return {k: v[0] for k, v in batch_unravel(z[None]).items()}

        if epsilons is None:
            eps_mat = streams.randn((num_mc_samples,) + mu.shape, generator=generator,
                                    dtype=mu.dtype, device=mu.device, chain_axis=None)
        else:
            eps_mat = tree_batch_ravel(epsilons)[0]
        with torch.enable_grad():
            mu_leaf, rho_leaf = mu.requires_grad_(True), rho.requires_grad_(True)
            theta = batch_unravel(mu_leaf + torch.exp(rho_leaf) * eps_mat)
            loss = -(batched(theta, batch).mean() + _gaussian_entropy(rho_leaf))
            g_mu, g_rho = torch.autograd.grad(loss, [mu_leaf, rho_leaf])
        mu, rho = mu.detach(), rho.detach()
        t = state.step + 1.0
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t          # bias corrections, 0-d tensors

        def adam(m, v, g, x):
            # m' = b1 m + (1 - b1) g; v' = b2 v + (1 - b2) g^2;
            # x' = x - lr (m' / c1) / (sqrt(v' / c2) + eps)
            m, v = _ravel(m)[0], _ravel(v)[0]
            m = torch.lerp(g, m, b1)
            v = torch.addcmul(b2 * v, g, g, value=1 - b2)
            x = torch.addcdiv(x, m, c1 * (torch.sqrt(v / c2) + eps), value=-learning_rate)
            return unravel(m), unravel(v), unravel(x)

        m_mu, v_mu, new_mu = adam(state.opt_mu, state.opt2_mu, g_mu, mu)
        m_rho, v_rho, new_rho = adam(state.opt_rho, state.opt2_rho, g_rho, rho)
        return MeanFieldState(new_mu, new_rho, m_mu, m_rho, v_mu, v_rho, t), loss.detach()

    return step


def fit(kernel: Callable, initial_state: MeanFieldState, data: Batch, batch_size: int,
        num_steps: int, *, generator: torch.Generator):
    """``num_steps`` ELBO steps, each on one fresh minibatch (uniform rows
    with replacement) shared by the step's MC draws, without a read from the
    device; returns (state, losses (num_steps,))."""
    leaf = next(iter(initial_state.mu.values()))
    n_data = data[0].shape[0]
    state = initial_state
    losses = torch.empty((num_steps,), dtype=torch.float32, device=leaf.device)
    for i in range(num_steps):
        idx = streams.randint(0, n_data, (batch_size,), generator=generator,
                              device=leaf.device, chain_axis=None)
        state, losses[i] = kernel(state, tuple(d[idx] for d in data), generator=generator)
    return state, losses


def sample_from(state: MeanFieldState, num_samples: int, *,
                generator: Optional[torch.Generator] = None,
                epsilons: Optional[Params] = None) -> Params:
    """Posterior samples from the fitted q: leaves (num_samples, ...)."""
    if epsilons is None:
        epsilons = _randn_draws(state.mu, num_samples, generator)
    return {k: m + torch.exp(state.rho[k]) * epsilons[k] for k, m in state.mu.items()}
