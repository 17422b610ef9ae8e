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


def draw_diagnostics(draws, device, block_bytes: int = 1 << 28) -> Dict[str, Any]:
    """ESS, split R-hat and mean of draws that lie elsewhere than ``device``
    (a pinned host buffer, a file read back), without ever holding them on
    ``device`` whole: each leaf's parameter axis is cut into blocks of about
    ``block_bytes``, and one block at a time is moved and reduced.

    ``draws``: a dict of (chains, draws, ...) tensors, views allowed.
    Returns {"ess": every coordinate's ESS in one vector, "rhat": likewise,
    "mean": a dict of posterior means on ``device``}, leaves in sorted key
    order."""
    ess_parts, rhat_parts, means = [], [], {}
    for name, leaf in sorted(draws.items()):
        chains, num_draws = leaf.shape[:2]
        flat = leaf.flatten(2) if leaf.dim() > 2 else leaf[:, :, None]
        width = max(block_bytes // (4 * chains * num_draws), 1)
        mean_parts = []
        for p0 in range(0, flat.shape[2], width):
            block = flat[:, :, p0:p0 + width].to(device)
            ess_parts.append(effective_sample_size(block).reshape(-1))
            rhat_parts.append(split_rhat(block).reshape(-1))
            mean_parts.append(block.mean(dim=(0, 1)))
        means[name] = torch.cat(mean_parts).reshape(leaf.shape[2:])
    return {"ess": torch.cat(ess_parts), "rhat": torch.cat(rhat_parts), "mean": means}
