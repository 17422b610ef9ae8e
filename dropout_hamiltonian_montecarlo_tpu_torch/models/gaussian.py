"""1-D / diagonal Gaussian density target (a sampler sanity check)."""

from __future__ import annotations

import math

import torch

from .base import Model, Params


class Gaussian(Model):
    """Independent Gaussian target N(mu, sigma^2) over params['x'] of shape
    (..., dim).  ``mu`` and ``sigma`` (scalars or (dim,) vectors) live on
    ``device``."""

    chain_batched = True

    def __init__(self, mu=0.0, sigma=1.0, dim: int = 1, device=None):
        self.mu = torch.as_tensor(mu, dtype=torch.float32, device=device)
        self.sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
        self.dim = dim

    def log_prior(self, params: Params) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.mu.device)

    def log_likelihood(self, params: Params, batch=None) -> torch.Tensor:
        z = (params["x"] - self.mu) / self.sigma
        return (-0.5 * z * z - torch.log(self.sigma) - 0.5 * math.log(2.0 * math.pi)).sum(dim=-1)

    def init_params(self, generator: torch.Generator, device) -> Params:
        return {"x": torch.zeros((self.dim,), dtype=torch.float32, device=device)}

    def analytic_grad(self, params: Params, batch=None) -> Params:
        """Closed-form gradient of the log density."""
        return {"x": -(params["x"] - self.mu) / (self.sigma ** 2)}
