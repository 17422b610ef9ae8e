"""No-U-Turn Sampler: the state and info types, the trailing-bits helpers
that the lockstep chain-batched kernel (inference/nuts_batched.py) uses, and
the per-chain kernel.

``build_kernel`` takes one chain's ``logdensity_fn`` (params dict -> scalar).
Every state of the port carries a chain axis, and ``jax.vmap`` of the JAX
package's per-chain kernel is lockstep NUTS with per-chain masks, so the
per-chain kernel is the lockstep tree-building kernel of nuts_batched.py on the
lifted value+grad.  With ``metric=`` the trees are built in the whitened
coordinates e = M^{1/2} q while the public state stays in parameter space.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.integrators import lift_value_and_grad
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


def init(position: Params, logdensity_fn: Callable) -> NUTSState:
    """State at chain-batched ``position`` (leaves (C, ...)) from one chain's
    ``logdensity_fn``."""
    value, grad = lift_value_and_grad(logdensity_fn)(position)
    return NUTSState(position, value, grad)


def build_kernel(logdensity_fn: Callable, max_tree_depth: int = 10,
                 divergence_threshold: float = 1000.0, metric=None):
    """Returns ``step(state, step_size, inv_mass, *, draws=None,
    generator=None) -> (state, info)`` for one chain's ``logdensity_fn``, run
    over the chain axis: state leaves (C, ...), ``step_size`` (C,), info
    fields (C,).  ``draws`` is a ``nuts_batched.NUTSDraws``.

    ``metric``: a metric with ``whiten``/``unwhiten`` and their transposes
    (ops.metrics.dense_metric, ops.kron_metric.KronMetric).  NUTS then runs
    in the whitened coordinates e = M^{1/2} q with an identity mass matrix,
    which is algebraically NUTS under mass matrix M but keeps every internal
    array O(1) in float32; ``inv_mass`` is ignored.  The public state
    (position, logdensity_grad) stays in parameter space: a gradient moves to
    whitened space through the transpose of ``unwhiten`` and back through the
    transpose of ``whiten``."""
    from .nuts_batched import build_batched_kernel

    value_and_grad_fn = lift_value_and_grad(logdensity_fn)
    if metric is None:
        return build_batched_kernel(value_and_grad_fn, max_tree_depth, divergence_threshold)
    needed = ("whiten", "unwhiten", "whiten_transpose", "unwhiten_transpose")
    if any(getattr(metric, name, None) is None for name in needed):
        raise ValueError("nuts metric support needs metric.whiten/unwhiten and their "
                         "transposes")

    def whitened_value_and_grad(e: Params):
        value, grad_q = value_and_grad_fn(metric.unwhiten(e))
        return value, metric.unwhiten_transpose(grad_q)

    inner = build_batched_kernel(whitened_value_and_grad, max_tree_depth,
                                 divergence_threshold)

    def step(state: NUTSState, step_size: torch.Tensor, inv_mass: Optional[Params] = None,
             *, draws=None, generator: Optional[torch.Generator] = None):
        whitened = NUTSState(metric.whiten(state.position), state.logdensity,
                             metric.unwhiten_transpose(state.logdensity_grad))
        new, info = inner(whitened, step_size, None, draws=draws, generator=generator)
        return NUTSState(metric.unwhiten(new.position), new.logdensity,
                         metric.whiten_transpose(new.logdensity_grad)), info

    return step
