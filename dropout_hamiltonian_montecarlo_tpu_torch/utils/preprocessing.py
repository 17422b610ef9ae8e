"""Data preprocessing helpers: one-hot labels, min-max scaling, flatten."""

from __future__ import annotations

from typing import Iterable, List

import torch


def one_hot(y, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    """Integer labels -> one-hot matrix (B, num_classes), where ``y`` lies."""
    y = torch.as_tensor(y).to(torch.int64)
    return (y[..., None] == torch.arange(num_classes, device=y.device)).to(dtype)


class MinMaxScaler:
    """Min-max feature scaling: fit stores per-feature (min, max)."""

    def __init__(self):
        self.min_ = None
        self.max_ = None

    def fit(self, X):
        X = torch.as_tensor(X)
        self.min_ = X.min(dim=0).values
        self.max_ = X.max(dim=0).values
        return self

    def transform(self, X):
        span = self.max_ - self.min_
        scale = torch.where(span > 0, span, torch.ones_like(span))
        return (torch.as_tensor(X) - self.min_) / scale

    def fit_transform(self, X):
        return self.fit(X).transform(X)


def flatten(items) -> List:
    """Recursively flatten nested iterables."""
    out: List = []
    for x in items:
        if isinstance(x, Iterable) and not isinstance(x, (str, bytes)):
            out.extend(flatten(x))
        else:
            out.append(x)
    return out
