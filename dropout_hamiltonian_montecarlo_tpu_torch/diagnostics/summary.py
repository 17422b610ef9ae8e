"""Posterior summary: mean/std/ESS/R-hat table over a dict of draws."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .ess import effective_sample_size
from .rhat import split_rhat


def median(x: torch.Tensor) -> torch.Tensor:
    """The median as numpy and JAX take it: the mean of the two middle
    values for an even count (``torch.median`` returns the lower one)."""
    return torch.quantile(x.reshape(-1).to(torch.float64), 0.5).to(x.dtype)


def summarize(positions, elapsed_seconds: Optional[float] = None) -> Dict[str, Any]:
    """positions: a dict of (chains, draws, ...) tensors, or one tensor.

    Returns per-leaf {mean, std, ess, rhat} under the leaf's key (sorted, as
    the JAX package flattens a dict; "" for a bare tensor) plus scalar
    aggregates: min/median ESS, max R-hat, and the ESS rates when
    ``elapsed_seconds`` is given."""
    items = (sorted(positions.items()) if isinstance(positions, dict)
             else [("", positions)])
    out = {}
    all_ess, all_rhat = [], []
    for name, leaf in items:
        ess = effective_sample_size(leaf)
        rhat = split_rhat(leaf)
        out[name] = {
            "mean": leaf.mean(dim=(0, 1)),
            "std": leaf.std(dim=(0, 1), correction=0),
            "ess": ess,
            "rhat": rhat,
        }
        all_ess.append(ess.reshape(-1))
        all_rhat.append(rhat.reshape(-1))
    ess_cat = torch.cat(all_ess)
    rhat_cat = torch.cat(all_rhat)
    out["aggregate"] = {
        "min_ess": ess_cat.min(),
        "median_ess": median(ess_cat),
        "max_rhat": rhat_cat.max(),
    }
    if elapsed_seconds is not None:
        out["aggregate"]["min_ess_per_sec"] = ess_cat.min() / elapsed_seconds
        out["aggregate"]["median_ess_per_sec"] = median(ess_cat) / elapsed_seconds
    return out
