"""Split-R-hat potential scale reduction (Gelman-Rubin / Vehtari et al.),
vectorised over all parameter coordinates."""

from __future__ import annotations

import torch


def potential_scale_reduction(samples: torch.Tensor) -> torch.Tensor:
    """Classic R-hat.  samples: (chains, draws, ...) -> R-hat per coordinate."""
    draws = samples.shape[1]
    chain_mean = samples.mean(dim=1)                          # (C, ...)
    chain_var = samples.var(dim=1, correction=1)              # (C, ...)
    w = chain_var.mean(dim=0)
    b = draws * chain_mean.var(dim=0, correction=1)
    var_plus = (draws - 1.0) / draws * w + b / draws
    return torch.sqrt(var_plus / w)


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split each chain in half before computing R-hat (detects
    within-chain nonstationarity).  samples: (chains, draws, ...)."""
    half = samples.shape[1] // 2
    split = torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)
    return potential_scale_reduction(split)


def split_rhat_pytree(positions):
    """Split-R-hat of every leaf of a dict of (chains, draws, ...) tensors
    (or of one tensor)."""
    if isinstance(positions, dict):
        return {k: split_rhat(v) for k, v in positions.items()}
    return split_rhat(positions)
