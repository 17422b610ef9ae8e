"""Effective sample size via batched FFT autocorrelation: a frozen copy of
the port's ``diagnostics/ess.py`` (the bench's FFT ESS), kept here so that a
change to the program cannot move the yardstick.

Stan / Vehtari et al.: per-chain FFT autocovariance, Geyer's initial
monotone positive sequence, combined across chains with the between-chain
variance, vectorised over the parameter axis (blocked to bound memory).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _fft_len(n: int) -> int:
    m = 1
    while m < 2 * n:
        m *= 2
    return m


def _autocovariance_fft(x: torch.Tensor) -> torch.Tensor:
    """Per-chain autocovariance over the last axis: (..., N) -> (..., N)."""
    n = x.shape[-1]
    x = x - x.mean(dim=-1, keepdim=True)
    m = _fft_len(n)     # zero-pad to a power of two >= 2n: linear, not circular
    f = torch.fft.rfft(x, n=m, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-1)[..., :n]
    return acov / n


def _ess_block(x: torch.Tensor) -> torch.Tensor:
    """ESS of each row of a (P, C, N) block -> (P,)."""
    chains, draws = x.shape[1], x.shape[2]
    acov = _autocovariance_fft(x)                              # (P, C, N)
    chain_var = acov[..., 0] * draws / (draws - 1.0)           # (P, C)
    mean_var = chain_var.mean(dim=-1)                          # W, (P,)
    if chains > 1:
        between = draws * torch.var(x.mean(dim=-1), dim=-1, correction=1)
        var_plus = mean_var * (draws - 1.0) / draws + between / draws
    else:
        var_plus = mean_var

    mean_acov = acov.mean(dim=1)                               # (P, N)
    rho = 1.0 - (mean_var[:, None] - mean_acov) / var_plus[:, None]
    rho[:, 0] = 1.0

    # Geyer: sum consecutive pairs, keep while positive, monotone envelope
    n_pairs = draws // 2
    paired = rho[:, : 2 * n_pairs].reshape(-1, n_pairs, 2).sum(dim=-1)
    paired = torch.cummin(paired, dim=1).values
    keep = torch.cumprod((paired > 0.0).to(paired.dtype), dim=1)
    tau = -1.0 + 2.0 * (paired * keep).sum(dim=1)
    tau = torch.clamp(tau, min=1.0 / math.log10(float(draws) + 1.0))
    ess = chains * draws / tau
    return torch.clamp(ess, max=float(chains * draws))


def effective_sample_size(samples: torch.Tensor,
                          block_size: Optional[int] = None) -> torch.Tensor:
    """ESS per parameter of ``samples`` (chains, draws, ...): the extra axes
    are independent parameters, and the result has their shape.

    The FFT buffer is (P, C, 2*draws) complex, so the parameter axis is
    processed in blocks: ``block_size=None`` picks blocks of about 256 MB,
    ``0`` forces one batch, a positive value sets the block length.
    """
    scalar_input = samples.dim() == 2
    chains, draws = samples.shape[0], samples.shape[1]
    param_shape = samples.shape[2:]
    x = samples.reshape(chains, draws, -1).permute(2, 0, 1)    # (P, C, N) view
    P = x.shape[0]

    if block_size is None:
        per_param_bytes = chains * _fft_len(draws) * 8 * 3
        fit = max((1 << 28) // max(per_param_bytes, 1), 1)
        block_size = 0 if fit >= P else fit
    if block_size and P > block_size:
        ess = torch.cat([_ess_block(x[i:i + block_size].contiguous())
                         for i in range(0, P, block_size)])
    else:
        ess = _ess_block(x.contiguous())
    if scalar_input:
        return ess[0]
    return ess.reshape(param_shape)

