"""Carry parameters and metric setups from the JAX package to the port.

``load_gn_setup(npz_path, alpha, device)`` reads a metric setup written by
either package (see ops.kron_metric)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops.kron_metric import load_gn_setup  # noqa: F401  (re-exported)


def params_from_jax(np_dict: Mapping[str, np.ndarray], device) -> dict:
    """JAX parameter arrays (as numpy, single-chain {'weights': (D, K),
    'bias': (K,)} or chain-batched (C, D, K) / (C, K)) -> float32 tensors on
    ``device``, same keys and shapes."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in np_dict.items()}
