"""Momentum SGD with input-feature dropout: the MAP / baseline optimizer.

Classical momentum m = gamma * m + eps * grad(log p); theta += m, and the
``fit_dropout`` variant, which multiplies the minibatch's INPUT FEATURES by a
fresh Bernoulli keep-mask each step (no rescale).  The state carries a
leading chain axis like every state of this package; the update is written
out on the parameter dict so that a step equals the JAX package's exactly.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Tuple

import torch

from ..ops import streams
from ..ops.tree import Params, tree_batch_ravel, tree_zeros_like
from .sgmcmc import Batch, _as_scalar, _make_vag


class SGDState(NamedTuple):
    position: Params
    momentum: Params


class SGDDraws(NamedTuple):
    """The random numbers of one step: the minibatch rows (C, B) that ``fit``
    gathers, and the bool keep-mask over the inputs (the batch's X shape)."""

    indices: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


def sgd_init(position: Params) -> SGDState:
    """State at chain-batched ``position`` (leaves (C, ...))."""
    return SGDState(position, tree_zeros_like(position))


def build_sgd_kernel(logdensity_fn: Callable[[Params, Batch], torch.Tensor],
                     gamma: float = 0.9, dropout_rate: float = 0.0):
    """Returns ``step(state, batch, step_size, *, draws=None, generator=None)
    -> (state, loss)``; the loss is the (C,) negative log density.

    With dropout_rate > 0, a fresh Bernoulli(1 - dropout_rate) keep-mask
    multiplies the batch inputs each step.  Maximises ``logdensity_fn``
    (``(params, batch) -> (C,)``, or one chain's, see ``sgmcmc._make_vag``)."""
    vag, _ = _make_vag(logdensity_fn, False, None)

    def step(state: SGDState, batch: Batch, step_size, *, draws: Optional[SGDDraws] = None,
             generator: Optional[torch.Generator] = None):
        X = batch[0]
        if dropout_rate > 0.0:
            # a per-chain batch (C, B, D) has the chain axis first; a shared
            # one (B, D) has none
            mask = draws.mask if draws is not None else streams.keep_mask(
                X.shape, 1.0 - dropout_rate, generator=generator, device=X.device,
                chain_axis=0 if X.dim() == 3 else None)
            batch = (X * mask.to(X.dtype),) + tuple(batch[1:])
        value, grad = vag(state.position, batch, None)
        step_size = _as_scalar(step_size, state.position)
        # all leaves side by side: one launch per term, not one per leaf
        q, unravel = tree_batch_ravel(state.position)
        m, g = tree_batch_ravel(state.momentum)[0], tree_batch_ravel(grad)[0]
        m = torch.addcmul(gamma * m, g, step_size)
        return SGDState(unravel(q + m), unravel(m)), -value

    return step


def fit(kernel: Callable, initial_state: SGDState, data: Batch, batch_size: int,
        num_steps: int, step_size: float, *, generator: Optional[torch.Generator] = None,
        draws: Optional[Iterable[SGDDraws]] = None) -> Tuple[SGDState, torch.Tensor]:
    """``num_steps`` SGD steps over random minibatches, one per chain and
    step, without a read from the device; returns (state, losses (C,
    num_steps)).  ``draws``: one ``SGDDraws`` per step in place of the
    generator."""
    leaf = next(iter(initial_state.position.values()))
    chains, n_data = leaf.shape[0], data[0].shape[0]
    eps = _as_scalar(step_size, initial_state.position)
    draws = iter(draws) if draws is not None else None
    state = initial_state
    losses = leaf.new_empty((chains, num_steps))
    for i in range(num_steps):
        given = next(draws) if draws is not None else None
        idx = given.indices if given is not None else streams.randint(
            0, n_data, (chains, batch_size), generator=generator, device=leaf.device)
        state, loss = kernel(state, tuple(d[idx] for d in data), eps, draws=given,
                             generator=generator)
        losses[:, i] = loss
    return state, losses
