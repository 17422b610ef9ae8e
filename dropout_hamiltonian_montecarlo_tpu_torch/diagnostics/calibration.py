"""Predictive-calibration diagnostics: ECE, reliability bins, NLL, and the
posterior-predictive probabilities they are computed on."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def reliability_bins(probs: torch.Tensor, labels: torch.Tensor, num_bins: int = 15):
    """Per-bin (count, mean confidence, mean accuracy) over max-prob bins.

    probs: (N, K) predictive probabilities; labels: (N,) int classes.
    Bin b covers confidences (b/B, (b+1)/B].  Returns (counts (B,),
    conf (B,), acc (B,)), the reliability diagram."""
    conf, pred = probs.max(dim=-1)                            # (N,)
    correct = (pred == labels).to(probs.dtype)
    idx = torch.clamp((conf * num_bins).to(torch.int64), 0, num_bins - 1)
    zeros = torch.zeros(num_bins, dtype=probs.dtype, device=probs.device)
    counts = zeros.index_add(0, idx, torch.ones_like(conf))
    conf_sum = zeros.index_add(0, idx, conf)
    acc_sum = zeros.index_add(0, idx, correct)
    safe = torch.clamp(counts, min=1.0)
    return counts, conf_sum / safe, acc_sum / safe


def expected_calibration_error(probs: torch.Tensor, labels: torch.Tensor,
                               num_bins: int = 15) -> torch.Tensor:
    """ECE = sum_b (n_b / N) * |acc_b - conf_b| (Guo et al. 2017)."""
    counts, conf, acc = reliability_bins(probs, labels, num_bins)
    return (counts / counts.sum() * (acc - conf).abs()).sum()


def predictive_nll(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the true labels."""
    p = torch.gather(probs, -1, labels[:, None].to(torch.int64))[:, 0]
    return -torch.log(torch.clamp(p, min=1e-12)).mean()


def posterior_predictive_probs(predict_prob_fn: Callable, draws, X: torch.Tensor,
                               max_draws: int = 64) -> torch.Tensor:
    """Class probabilities averaged over a thinned subset of posterior draws.

    predict_prob_fn: (params, X) -> (N, K) probabilities.  draws: a dict of
    (chains, num_draws, ...) tensors.  Every ``total // max_draws``-th of
    the flattened draws is used, at most ``max_draws`` of them.  The draws
    may lie elsewhere than ``X`` (a host buffer): only the draws used are
    moved, one at a time."""
    chains, num_draws = next(iter(draws.values())).shape[:2]
    total = chains * num_draws
    take = min(max_draws, total)
    stride = max(total // take, 1)
    acc = None
    for i in range(take):
        c, t = divmod(i * stride, num_draws)
        p = predict_prob_fn({k: v[c, t].to(X.device) for k, v in draws.items()}, X)
        acc = p if acc is None else acc + p
    return acc / take


def calibration_report(probs: torch.Tensor, labels: torch.Tensor,
                       num_bins: int = 15) -> Dict[str, float]:
    labels = labels.to(torch.int64)
    acc = float((probs.argmax(dim=-1) == labels).to(torch.float32).mean())
    return {
        "accuracy": acc,
        "ece": float(expected_calibration_error(probs, labels, num_bins)),
        "nll": float(predictive_nll(probs, labels)),
    }
