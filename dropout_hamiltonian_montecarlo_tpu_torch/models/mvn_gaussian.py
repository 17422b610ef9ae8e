"""Multivariate normal density target.

The Cholesky factor and its inverse are computed once at construction, so a
log density costs one small matmul for all chains.
"""

from __future__ import annotations

import math

import torch

from .base import Model, Params


class MVNGaussian(Model):
    """Target N(mu, cov) over params['x'] of shape (..., dim); exact moments
    known for tests.  The factors live where ``mu`` and ``cov`` lie (pass
    tensors on the sampler's device)."""

    chain_batched = True

    def __init__(self, mu, cov):
        self.mu = torch.as_tensor(mu, dtype=torch.float32)
        self.cov = torch.as_tensor(cov, dtype=torch.float32).to(self.mu.device)
        self.dim = self.mu.shape[0]
        self.chol = torch.linalg.cholesky(self.cov)
        self.chol_inv = torch.linalg.solve_triangular(
            self.chol, torch.eye(self.dim, device=self.mu.device), upper=False)
        self.log_det = 2.0 * torch.log(torch.diagonal(self.chol)).sum()
        self.prec = torch.linalg.inv(self.cov)

    def log_prior(self, params: Params) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.mu.device)

    def log_likelihood(self, params: Params, batch=None) -> torch.Tensor:
        diff = params["x"] - self.mu
        # z = L^-1 diff  =>  diff^T Sigma^-1 diff = ||z||^2
        z = diff @ self.chol_inv.T
        return -0.5 * (self.dim * math.log(2.0 * math.pi) + self.log_det
                       + (z * z).sum(dim=-1))

    def init_params(self, generator: torch.Generator, device) -> Params:
        return {"x": torch.zeros((self.dim,), dtype=torch.float32, device=device)}

    def analytic_grad(self, params: Params, batch=None) -> Params:
        """Closed-form gradient of the log density: -(x - mu) Sigma^-1."""
        return {"x": -(params["x"] - self.mu) @ self.prec}
