"""Data-parallel gradients: each rank holds a shard of the rows, the value
and gradient are summed over the ranks of a chain block.

The JAX package lays the example axis over the 'data' mesh axis and psums.
Here a rank keeps its contiguous rows (``shard_data``), computes the local
value and gradient, and one all-reduce over ``layout.data_group`` sums both:
the sum of the shards' gradients, never the gradient of a sum (the reduction
is not differentiated).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import mesh
from .mesh import RankLayout

Batch = Tuple[torch.Tensor, ...]


def shard_rows(num_rows: int, layout: RankLayout) -> Tuple[int, int]:
    """The rows [start, stop) of ``num_rows`` that this rank's data shard
    holds: equal contiguous blocks in shard order.  A trailing remainder is
    refused (ValueError), as the JAX package's device_put over the 'data'
    axis refuses it: every shard scales its likelihood by its rows times the
    shard count, which is the global row count only when the shards are
    equal."""
    shards = layout.num_data_shards
    if num_rows % shards != 0:
        raise ValueError(f"{num_rows} rows % {shards} data shards != 0: a shard scales its "
                         f"likelihood by its rows x {shards}, so the shards must be equal")
    per = num_rows // shards
    return layout.data_index * per, (layout.data_index + 1) * per


def shard_data(data: Batch, layout: RankLayout) -> Batch:
    """This rank's rows of every array of ``data`` (views, leading axis)."""
    start, stop = shard_rows(data[0].shape[0], layout)
    return tuple(d[start:stop] for d in data)


def _local_contribution(model, data_size: int, num_shards: int, keyed: bool = False):
    """A shard's term of the minibatch log density: the prior divided by the
    shard count, so that the sum over the shards counts it once, and the
    likelihood scaled by data_size over the GLOBAL batch (local rows times
    the shard count).  ``keyed``: the likelihood takes the dropout masks,
    which every shard of a chain draws alike (its generator is seeded alike),
    since the masks perturb the parameters, not the data."""

    def contribution(params, local_batch, masks=None):
        global_bs = model.batch_size(local_batch) * num_shards
        ll = (model.log_likelihood(params, local_batch, masks) if keyed
              else model.log_likelihood(params, local_batch))
        ll = (data_size / global_bs) * ll
        return model.log_prior(params) / num_shards + ll

    return contribution


def make_sharded_logdensity(model, data_size: int, layout: RankLayout):
    """The minibatch log density summed over ``layout.data_group``:
    ``(params, local_batch) -> (C,)``.  The all-reduce is not differentiated:
    for gradients use ``make_sharded_value_and_grad``."""
    contribution = _local_contribution(model, data_size, layout.num_data_shards)

    def logdensity(params, local_batch):
        return mesh.all_reduce_sum([contribution(params, local_batch)], layout.data_group)[0]

    logdensity.chain_batched = True
    return logdensity


def _uses_fused_kernel(model, local_batch, keyed: bool) -> bool:
    """The softmax model on one batch shared by every chain (a 2-D X) goes
    through the fused softmax-GLM kernel (its plain version on the CPU)."""
    return (not keyed and hasattr(model, "make_fused_value_and_grad")
            and local_batch[0].dim() == 2)


def make_sharded_value_and_grad(model, data_size: int, layout: RankLayout,
                                keyed: bool = False):
    """Data-parallel value and gradient of the chain-batched minibatch log
    density, ``(params, local_batch, masks | None) -> ((C,) values, grads)``:
    the local value and gradient, then ONE all-reduce of both over
    ``layout.data_group``.  This is the ``(params, batch, masks | None)``
    shape of the SG-MCMC kernels' ``value_and_grad_fn`` hook, so
    ``build_sghmc_kernel(value_and_grad_fn=make_sharded_value_and_grad(...),
    keyed=...)`` is the data-parallel sampler; with ``keyed`` it carries the
    model's ``draw_masks``.

    Two local terms:
    - the softmax model on a batch shared by all chains (X of shape (N, D),
      the full-batch case): the fused kernel with ``include_prior=False`` on
      the shard's rows (``softmax_value_and_grad``, the CUDA kernel for CUDA
      tensors), scaled by data_size over the global rows; after the
      all-reduce the prior and its gradient are added once;
    - any other model: autograd of ``_local_contribution`` (the prior over
      the shard count, the scaled likelihood), then the all-reduce.

    With one data shard and no group, the second is the arithmetic of
    ``model.make_batched_logdensity(data_size)`` under ``_make_vag``, so the
    draws are those of ``run_sgmcmc_chains``, bit for bit."""
    n_shards = layout.num_data_shards
    contribution = _local_contribution(model, data_size, n_shards, keyed)
    pieces = {}     # the kernel's bf16 pieces of the last X, cut once

    def value_and_grad(params, local_batch, masks=None):
        keys = list(params)
        if _uses_fused_kernel(model, local_batch, keyed):
            from ..ops.softmax_glm import (log_prior_batched, softmax_value_and_grad,
                                           split_bf16_input)

            X, Y = local_batch
            if X.is_cuda and pieces.get("X") is not X:
                pieces.update(X=X, split=split_bf16_input(X))
            W, b = params["weights"], params["bias"]
            scale = data_size / (X.shape[0] * n_shards)
            ll, gw, gb = softmax_value_and_grad(X, Y, W, b, model.alpha, include_prior=False,
                                                x_split=pieces.get("split"))
            if scale != 1.0:
                ll, gw, gb = scale * ll, scale * gw, scale * gb
            ll, gw, gb = mesh.all_reduce_sum([ll, gw, gb], layout.data_group)
            return (ll + log_prior_batched(W, b, model.alpha),
                    {"weights": gw - model.alpha * W, "bias": gb - model.alpha * b})
        with torch.enable_grad():
            leaves = [params[k].detach().requires_grad_(True) for k in keys]
            value = contribution(dict(zip(keys, leaves)), local_batch, masks)
            grads = torch.autograd.grad(value.sum(), leaves)
        value, *grads = mesh.all_reduce_sum([value.detach(), *grads], layout.data_group)
        return value, dict(zip(keys, grads))

    value_and_grad.chain_batched = True
    if keyed:
        value_and_grad.draw_masks = lambda params, batch, generator: model.draw_masks(
            params, batch[0], generator)
    return value_and_grad
