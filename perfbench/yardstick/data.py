"""The inputs of every cell, made on the device from the run seed.

``synthetic_mnist`` is the recipe of the port's ``io/datasets.py::mnist``
synthetic stand-in (class-conditional pixel means, |normal| noise, 4% label
noise, pixels on the 8-bit grid k/256), drawn with a ``torch.Generator`` on
the device from ``--seed`` in a few large calls.  The same tensors go to the
program and to the reference."""

from __future__ import annotations

import torch

from . import seeds


def synthetic_mnist(seed: int, device, n: int = 60000, dim: int = 784,
                    n_classes: int = 10):
    """(X float32 (n, dim) on the k/256 grid, y int64 (n,)) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, seeds.DATA))
    f = dict(generator=gen, device=device)
    centers = torch.rand((n_classes, dim), **f) * 0.12
    y = torch.randint(0, n_classes, (n,), **f)
    X = centers[y] + 0.3 * torch.randn((n, dim), **f).abs()
    flip = torch.rand((n,), **f) < 0.04
    y = torch.where(flip, torch.randint(0, n_classes, (n,), **f), y)
    X = torch.round(X.clamp_(0.0, 1.0) * 256.0) / 256.0
    return X.contiguous(), y
