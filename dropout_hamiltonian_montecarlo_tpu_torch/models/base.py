"""Model protocol.

- ``params`` is a dict of tensors.
- ``batch`` is a tuple ``(X, y)`` (or None for density targets).  Its rows
  lie on the second-to-last axis of ``X``: ``X`` is (B, D), one batch shared
  by every chain, or (C, B, D), one minibatch per chain (what the SG-MCMC
  run loop gathers; the softmax and MLP models take both).
- ``log_likelihood`` returns the SUM of per-datum log-likelihoods.
- ``log_posterior(params, batch, data_size)`` = log_prior + scale * log_lik
  with ``scale = data_size / batch_size`` (the unbiased minibatch estimator).
- Samplers maximise the log density.
- A model whose ``log_prior`` and ``log_likelihood`` broadcast over leading
  chain axes of the params (leaves (C, ...) -> (C,) values) sets
  ``chain_batched = True``; ``make_logdensity`` marks its closures so, and
  ``ops.integrators.lift_value_and_grad`` then evaluates all chains in one
  call.  Every model of this package is written that way.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Batch = Optional[Tuple[torch.Tensor, ...]]


class Model:
    """Base class: subclasses implement log_prior, log_likelihood and
    init_params.  Instances hold only hyperparameters (shapes, prior
    precision)."""

    chain_batched = False

    def log_prior(self, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def log_likelihood(self, params: Params, batch: Batch) -> torch.Tensor:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator, device) -> Params:
        raise NotImplementedError

    @staticmethod
    def batch_size(batch: Batch) -> int:
        """Rows per chain of a shared (B, D) or per-chain (C, B, D) batch."""
        return batch[0].shape[-2]

    def log_posterior(self, params: Params, batch: Batch = None,
                      data_size: Optional[int] = None) -> torch.Tensor:
        ll = self.log_likelihood(params, batch)
        if data_size is not None and batch is not None:
            ll = (data_size / self.batch_size(batch)) * ll
        return self.log_prior(params) + ll

    def potential(self, params: Params, batch: Batch = None,
                  data_size: Optional[int] = None) -> torch.Tensor:
        """Negative log posterior."""
        return -self.log_posterior(params, batch, data_size)

    def make_logdensity(self, batch: Batch = None,
                        data_size: Optional[int] = None) -> Callable[[Params], torch.Tensor]:
        """Close over a (full or mini) batch: the sampler-facing callable,
        one chain's params dict -> scalar."""
        def logdensity(params: Params) -> torch.Tensor:
            return self.log_posterior(params, batch, data_size)
        logdensity.chain_batched = self.chain_batched
        return logdensity

    def make_batched_logdensity(self, data_size: int) -> Callable[[Params, Batch], torch.Tensor]:
        """Minibatch form: ``(params, batch) -> scaled log posterior``."""
        def logdensity(params: Params, batch: Batch) -> torch.Tensor:
            return self.log_posterior(params, batch, data_size)
        logdensity.chain_batched = self.chain_batched
        return logdensity
