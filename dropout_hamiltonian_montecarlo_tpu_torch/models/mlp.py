"""Bayesian dropout MLP: the deep model of the zoo.

A 3-layer MLP n_in -> n_mid -> n_mid -> n_out with ReLU, a Gaussian prior
-0.5 * alpha * ||theta||^2, and dropout INSIDE the sampled potential: the
masks are explicit ``DropoutMasks`` (three bool keep-masks), drawn from a
``torch.Generator`` or passed in, so the potential is deterministic per
(chain, step) and autograd differentiates the very forward that gave the
value: value and gradient of a step see one mask.  That is what SG-MCMC over
a dropout network needs.

Params: {'W1', 'b1', 'W2', 'b2', 'W3', 'b3'}, one chain's ((D, H), (H,), ...)
or chain-batched ((C, D, H), (C, H), ...).  batch: (X, y one-hot), either
shared by every chain (X (B, D), y (B, K)) or one minibatch per chain
(X (C, B, D), y (C, B, K)).  The hidden activations, and so the masks, are
(C, B, H) (or (B, H) for one chain's params on a shared batch).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import streams
from .base import Model, Params


class DropoutMasks(NamedTuple):
    """Keep-masks (bool, True = kept) of one forward: on the first and second
    hidden linear outputs (before their ReLU) and on the last hidden
    activation (before the output layer)."""

    first: torch.Tensor
    second: torch.Tensor
    output: torch.Tensor


def _affine(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h W + b for one chain or over the chain axis (one batched GEMM)."""
    if W.dim() == 2:
        return torch.addmm(b, h, W)
    if h.dim() == 2:
        h = h.expand((W.shape[0],) + h.shape)
    return torch.baddbmm(b[:, None, :], h, W)


class DropoutMLP(Model):
    chain_batched = True

    def __init__(self, dim: int, hidden: int, n_classes: int, alpha: float = 1e-2,
                 p_drop: float = 0.1):
        self.dim = dim
        self.hidden = hidden
        self.n_classes = n_classes
        self.alpha = float(alpha)
        self.p_drop = p_drop

    # ---- forward ------------------------------------------------------------

    def draw_masks(self, params: Params, X: torch.Tensor,
                   generator: torch.Generator) -> DropoutMasks:
        """Fresh Bernoulli(1 - p_drop) keep-masks for one forward of
        ``params`` on ``X``."""
        lead = tuple(params["W1"].shape[:-2] if X.dim() == 2 else X.shape[:-2])
        shape = (3,) + lead + (X.shape[-2], self.hidden)
        # one draw and one compare for the three masks; the chain axis, where
        # there is one, follows the axis of the three
        keep = streams.keep_mask(shape, 1.0 - self.p_drop, generator=generator,
                                 device=X.device, chain_axis=1 if lead else None)
        return DropoutMasks(*keep.unbind(0))

    def logits(self, params: Params, X: torch.Tensor,
               masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        """Forward pass.  With masks, dropout is applied BEFORE the ReLU on
        each hidden linear output and once more before the output layer:
        relu(drop(l1(x))), relu(drop(l2(h))), l3(drop(h)), a kept unit divided
        by the keep probability.  Without masks the pass is deterministic: no
        mask and no rescale."""
        keep = 1.0 - self.p_drop

        def drop(mask, h):
            return h if mask is None else torch.where(mask, h / keep, 0.0)

        m1, m2, m3 = masks if masks is not None else (None, None, None)
        h = torch.relu(drop(m1, _affine(X, params["W1"], params["b1"])))
        h = torch.relu(drop(m2, _affine(h, params["W2"], params["b2"])))
        return _affine(drop(m3, h), params["W3"], params["b3"])

    # ---- Model interface ----------------------------------------------------

    def log_prior(self, params: Params) -> torch.Tensor:
        if params["W1"].dim() == 3:
            # all leaves side by side: one product and one sum per chain axis
            # instead of six (the step is bound by the host's launches)
            flat = torch.cat([p.flatten(1) for p in params.values()], dim=1)
            return -0.5 * self.alpha * (flat * flat).sum(dim=1)
        return -0.5 * self.alpha * sum((p * p).sum() for p in params.values())

    def log_likelihood(self, params: Params, batch,
                       masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        X, y = batch
        logp = torch.log_softmax(self.logits(params, X, masks), dim=-1)
        return (y * logp).sum(dim=(-2, -1))

    def log_posterior(self, params: Params, batch=None, data_size: Optional[int] = None,
                      masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        ll = self.log_likelihood(params, batch, masks)
        if data_size is not None and batch is not None:
            ll = (data_size / self.batch_size(batch)) * ll
        return self.log_prior(params) + ll

    def make_batched_logdensity(self, data_size: int, dropout: bool = False):
        """Minibatch log density ``(params, batch) -> (C,)``; with
        ``dropout=True`` the callable takes ``(params, batch, masks)`` and
        carries ``draw_masks(params, batch, generator)``, which the keyed
        SG-MCMC kernels call once per gradient."""
        if not dropout:
            return super().make_batched_logdensity(data_size)

        def logdensity(params: Params, batch, masks: DropoutMasks) -> torch.Tensor:
            return self.log_posterior(params, batch, data_size, masks)

        logdensity.chain_batched = True
        logdensity.draw_masks = lambda params, batch, generator: self.draw_masks(
            params, batch[0], generator)
        return logdensity

    def init_params(self, generator: torch.Generator, device) -> Params:
        def glorot(rows, cols):
            w = torch.randn((rows, cols), generator=generator, dtype=torch.float32,
                            device=device)
            return math.sqrt(2.0 / (rows + cols)) * w

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=device)

        return {"W1": glorot(self.dim, self.hidden), "b1": zeros(self.hidden),
                "W2": glorot(self.hidden, self.hidden), "b2": zeros(self.hidden),
                "W3": glorot(self.hidden, self.n_classes), "b3": zeros(self.n_classes)}

    def predict(self, params: Params, X: torch.Tensor, prob: bool = False):
        p = torch.softmax(self.logits(params, X), dim=-1)
        return p if prob else torch.argmax(p, dim=-1)

    def predict_stochastic(self, params: Params, X: torch.Tensor, *,
                           masks: Optional[DropoutMasks] = None,
                           generator: Optional[torch.Generator] = None, prob: bool = False):
        """MC-dropout prediction: one stochastic forward per call, under the
        given masks or fresh ones from ``generator``."""
        if masks is None:
            if generator is None:
                raise ValueError("pass masks= or an explicit generator=")
            masks = self.draw_masks(params, X, generator)
        p = torch.softmax(self.logits(params, X, masks), dim=-1)
        return p if prob else torch.argmax(p, dim=-1)
