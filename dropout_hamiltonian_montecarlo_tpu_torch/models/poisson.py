"""Bayesian Poisson GLM (log link).

Params: {'weights': (..., D), 'bias': (...)} (any leading chain axes); batch: (X (B, D), y (B,) counts).
"""

from __future__ import annotations

import torch

from .base import Model, Params


class Poisson(Model):
    chain_batched = True

    def __init__(self, dim: int, alpha: float = 1e-2):
        self.dim = dim
        self.alpha = float(alpha)

    def log_prior(self, params: Params) -> torch.Tensor:
        sq = (params["weights"] ** 2).sum(dim=-1) + params["bias"] ** 2
        return -0.5 * self.alpha * sq

    def log_rate(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return params["weights"] @ X.T + params["bias"][..., None]        # (..., B)

    def log_likelihood(self, params: Params, batch) -> torch.Tensor:
        X, y = batch
        eta = self.log_rate(params, X)
        # log p(y | lambda) = y eta - exp(eta) - log(y!), on the log rate so
        # that no rate is formed and logged again
        return (y * eta - torch.exp(eta) - torch.lgamma(y + 1.0)).sum(dim=-1)

    def init_params(self, generator: torch.Generator, device) -> Params:
        w = torch.randn((self.dim,), generator=generator, dtype=torch.float32, device=device)
        return {"weights": 1e-2 * w,
                "bias": torch.zeros((), dtype=torch.float32, device=device)}

    def predict(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_rate(params, X))

    def analytic_grad(self, params: Params, batch) -> Params:
        """Closed-form gradient of the log posterior."""
        X, y = batch
        resid = y - torch.exp(self.log_rate(params, X))
        return {"weights": resid @ X - self.alpha * params["weights"],
                "bias": resid.sum(dim=-1) - self.alpha * params["bias"]}
