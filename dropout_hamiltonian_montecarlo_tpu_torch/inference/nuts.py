"""No-U-Turn Sampler: the state and info types and the trailing-bits helpers
that the lockstep chain-batched kernel (inference/nuts_batched.py) uses.

The per-chain kernel (``build_kernel``/``init`` of the JAX package's
inference/nuts.py) is not ported yet: it comes with the per-chain HMC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.tree import Params


class NUTSState(NamedTuple):
    position: Params
    logdensity: torch.Tensor
    logdensity_grad: Params


class NUTSInfo(NamedTuple):
    acceptance_prob: torch.Tensor   # mean leaf accept-prob (dual-averaging statistic)
    is_accepted: torch.Tensor       # proposal differs from the initial point
    energy: torch.Tensor
    is_divergent: torch.Tensor
    num_integration_steps: torch.Tensor
    depth: torch.Tensor


def _bit_count(n: int) -> int:
    """Number of set bits of a non-negative int (the leaf counter is one
    scalar shared by every chain, so it lives on the host)."""
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    """Number of contiguous trailing 1-bits of a non-negative int."""
    count = 0
    while n & 1:
        n >>= 1
        count += 1
    return count
