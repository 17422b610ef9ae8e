"""Bayesian softmax (multinomial logistic) regression.

Params: {'weights': (D, K), 'bias': (K,)}, or chain-batched {'weights':
(C, D, K), 'bias': (C, K)}; batch: (X (B, D), y (B, K) one-hot) shared by
every chain, or one minibatch per chain (X (C, B, D), y (C, B, K)).  The log
density broadcasts over the chain axis (one GEMM for all chains on a shared
batch), which is what the per-chain samplers differentiate by autograd.  The fused
chain-batched value+grad (``make_fused_value_and_grad``) goes through
ops.softmax_glm instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .base import Model, Params


class Softmax(Model):
    chain_batched = True

    def __init__(self, dim: int, n_classes: int, alpha: float = 1e-2):
        self.dim = dim
        self.n_classes = n_classes
        self.alpha = float(alpha)

    def log_prior(self, params: Params) -> torch.Tensor:
        """Gaussian prior, per chain."""
        k = (self.dim + 1) * self.n_classes
        sq = (params["weights"] ** 2).sum(dim=(-2, -1)) + (params["bias"] ** 2).sum(dim=-1)
        return 0.5 * k * math.log(self.alpha / (2.0 * math.pi)) - 0.5 * self.alpha * sq

    def logits(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return X @ params["weights"] + params["bias"]

    def log_likelihood(self, params: Params, batch) -> torch.Tensor:
        X, y = batch
        W, b = params["weights"], params["bias"]
        if W.dim() == 2:
            return (y * torch.log_softmax(self.logits(params, X), dim=-1)).sum()
        if X.dim() == 3:     # one minibatch per chain
            z = torch.baddbmm(b[:, None, :], X, W)
            return (y * torch.log_softmax(z, dim=-1)).sum(dim=(1, 2))
        # all chains in one GEMM: X (B, D) @ W as (D, C K), logits kept (B, C, K)
        c, d, k = W.shape
        z = (X @ W.permute(1, 0, 2).reshape(d, c * k)).reshape(-1, c, k) + b
        return (y[:, None, :] * torch.log_softmax(z, dim=-1)).sum(dim=(0, 2))

    def init_params(self, generator: torch.Generator, device) -> Params:
        w = torch.randn((self.dim, self.n_classes), generator=generator,
                        dtype=torch.float32, device=device)
        return {"weights": 1e-2 * w,
                "bias": torch.zeros((self.n_classes,), dtype=torch.float32,
                                    device=device)}

    def predict(self, params: Params, X: torch.Tensor, prob: bool = False):
        p = torch.softmax(self.logits(params, X), dim=-1)
        return p if prob else torch.argmax(p, dim=-1)

    def predict_stochastic(self, params: Params, X: torch.Tensor, *,
                           mask: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None, p_drop: float = 0.5,
                           prob: bool = False):
        """MC-dropout prediction: a Bernoulli(1 - p_drop) keep-mask over the
        INPUT FEATURES (no rescale), the given ``mask`` (X's shape) or a
        fresh one from ``generator``."""
        if mask is None:
            if generator is None:
                raise ValueError("pass mask= or an explicit generator=")
            mask = torch.rand(X.shape, generator=generator, device=X.device) < 1.0 - p_drop
        return self.predict(params, X * mask.to(X.dtype), prob=prob)

    def analytic_grad(self, params: Params, batch) -> Params:
        """Closed-form gradient of the log posterior (one chain)."""
        X, y = batch
        resid = y - torch.softmax(self.logits(params, X), dim=-1)
        return {"weights": X.T @ resid - self.alpha * params["weights"],
                "bias": resid.sum(dim=0) - self.alpha * params["bias"]}

    def make_fused_value_and_grad(self, batch, fwd_full: bool = True,
                                  include_prior: bool = True, x_split=None,
                                  use_kernel: bool = True):
        """Chain-batched log-posterior value+grad through the fused
        softmax-GLM op (the CUDA kernel for CUDA tensors).

        ``fwd_full=True``: params -> ((C,) values, grads).  ``fwd_full=False``
        is the grad-only variant, params -> grads, for the inner leapfrog
        steps.  ``include_prior=False`` gives likelihood-only outputs.  The
        kernel's bf16 pieces of X (``ops.softmax_glm.split_bf16_input``) are
        cut here, once, for a CUDA X; pass the same ``x_split`` to several
        makers to share one copy.  The CPU route does not use them, and
        neither does ``use_kernel=False``, which asks for the plain version by
        name."""
        from ..ops.softmax_glm import softmax_value_and_grad, split_bf16_input

        X, y = batch
        if x_split is None and X.is_cuda and use_kernel:
            x_split = split_bf16_input(X)

        def vag(params: Params):
            value, gw, gb = softmax_value_and_grad(
                X, y, params["weights"], params["bias"], self.alpha,
                fwd_full=fwd_full, include_prior=include_prior, x_split=x_split,
                use_kernel=use_kernel)
            grads = {"weights": gw, "bias": gb}
            return (value, grads) if fwd_full else grads

        return vag
