"""Bayesian logistic regression.

Sigmoid-Bernoulli likelihood in the stable log-sigmoid form, Gaussian prior
with precision alpha (normalisation constants included), the unbiased
(N/B) minibatch scaling of models.base, and the hand-derived gradient
X^T (y - yhat) - alpha theta kept as ``analytic_grad``.

Params: {'weights': (..., D), 'bias': (...)} (any leading chain axes); batch: (X (B, D) float, y (B,) in {0, 1}).
"""

from __future__ import annotations

import math

import torch

from .base import Model, Params


class Logistic(Model):
    chain_batched = True

    def __init__(self, dim: int, alpha: float = 1e-2):
        self.dim = dim
        self.alpha = float(alpha)

    def log_prior(self, params: Params) -> torch.Tensor:
        k = self.dim + 1
        sq = (params["weights"] ** 2).sum(dim=-1) + params["bias"] ** 2
        return 0.5 * k * math.log(self.alpha / (2.0 * math.pi)) - 0.5 * self.alpha * sq

    def logits(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return params["weights"] @ X.T + params["bias"][..., None]        # (..., B)

    def log_likelihood(self, params: Params, batch) -> torch.Tensor:
        X, y = batch
        z = self.logits(params, X)
        # sum_i [ y_i log s(z_i) + (1 - y_i) log(1 - s(z_i)) ]; softplus stays
        # finite in f32 where log(1 + exp(z)) overflows
        return (y * z - torch.nn.functional.softplus(z)).sum(dim=-1)

    def init_params(self, generator: torch.Generator, device) -> Params:
        w = torch.randn((self.dim,), generator=generator, dtype=torch.float32, device=device)
        return {"weights": 1e-2 * w,
                "bias": torch.zeros((), dtype=torch.float32, device=device)}

    def predict(self, params: Params, X: torch.Tensor, prob: bool = False):
        p = torch.sigmoid(self.logits(params, X))
        return p if prob else (p > 0.5).to(torch.int32)

    def analytic_grad(self, params: Params, batch) -> Params:
        """Closed-form gradient of the log posterior."""
        X, y = batch
        resid = y - torch.sigmoid(self.logits(params, X))
        return {"weights": resid @ X - self.alpha * params["weights"],
                "bias": resid.sum(dim=-1) - self.alpha * params["bias"]}
