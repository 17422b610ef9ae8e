"""Model protocol.

- ``params`` is a dict of tensors.
- ``batch`` is a tuple ``(X, y)`` (or None for density targets).
- ``log_likelihood`` returns the SUM of per-datum log-likelihoods.
- ``log_posterior(params, batch, data_size)`` = log_prior + scale * log_lik
  with ``scale = data_size / batch_size`` (the unbiased minibatch estimator).
- Samplers maximise the log density.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Batch = Optional[Tuple[torch.Tensor, ...]]


class Model:
    """Base class: subclasses implement log_prior, log_likelihood and
    init_params.  Instances hold only hyperparameters (shapes, prior
    precision)."""

    def log_prior(self, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def log_likelihood(self, params: Params, batch: Batch) -> torch.Tensor:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator, device) -> Params:
        raise NotImplementedError

    def log_posterior(self, params: Params, batch: Batch = None,
                      data_size: Optional[int] = None) -> torch.Tensor:
        ll = self.log_likelihood(params, batch)
        if data_size is not None and batch is not None:
            ll = (data_size / batch[0].shape[0]) * ll
        return self.log_prior(params) + ll
