"""Lockstep chain-batched NUTS: all chains share each leapfrog step.

Every leaf of every chain's tree is ONE call of the chain-batched
``value_and_grad`` (the same callable hmc.build_batched_kernel takes), so the
fused softmax-GLM kernel serves every chain's leaf with one pass over the
data.  Chains whose trees have stopped (U-turn or divergence) are masked out
of every state update but ride along in the batched call; the doubling
schedule is shared, so the work per draw is the max over chains.

The algorithm is the JAX package's inference/nuts_batched.py, unchanged:
multinomial proposals within a subtree, biased progressive sampling across
subtrees, Betancourt's criterion with the boundary momenta at half weight,
trailing-bits checkpoints whose slots depend only on the shared leaf index,
and a per-chain ``chain_depth``.  The leaf index and the depth are host ints
here, so the checkpoint slot and the turning checks of a leaf are chosen on
the host, and only the one (C, D) slot a leaf stores is written.

Host syncs.  The subtree loop runs while any chain is unmasked.  Reading
that flag before each leaf would drain the device queue every leaf, so by
default (``sync_lag=1``) the flag of a leaf is copied to pinned memory
without blocking and read only before the NEXT leaf is enqueued: the card
always holds one leaf of work while the host waits.  This is exact: a leaf
whose chains are all masked changes no output (every update is a masked
select), and once every chain is masked all later leaves are masked too.
It costs at most one extra (masked) leaf per draw, which the kernel counts
in ``leaves_executed`` like any other.  ``sync_lag=0`` reads the flag before
the leaf it guards (the JAX loop's order): the reference the tests hold the
default against, 6-10% slower a draw at bench shape on an H100 80GB HBM3
at 700 W (PERF.md, section 5).

Every random number of a step can be injected (``draws=NUTSDraws(...)``);
otherwise the whole set is drawn from ``generator`` at the start of the step,
so a step consumes the same random numbers however many leaves it runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import streams
from ..ops.tree import Params, tree_batch_ravel
from ..utils import profiling
from .nuts import NUTSInfo, NUTSState, _bit_count, _trailing_ones


class NUTSDraws(NamedTuple):
    """Every random number of one step.  ``momentum`` is standard normal in
    the flat layout of ``ops.tree.tree_batch_ravel``; ``direction`` True
    extends a tree forward; ``leaf_uniform[d, i]`` decides the multinomial
    proposal at leaf i of the depth-d subtree; ``bias_uniform[d]`` the
    proposal across subtrees after depth d."""
    momentum: torch.Tensor       # (C, D)
    direction: torch.Tensor      # (max_depth, C) bool
    leaf_uniform: torch.Tensor   # (max_depth, 2 ** (max_depth - 1), C)
    bias_uniform: torch.Tensor   # (max_depth, C)


def sample_draws(num_chains: int, dim: int, max_tree_depth: int,
                 generator: torch.Generator, device, dtype=torch.float32) -> NUTSDraws:
    """A step's draws from ``generator``; the chain axis is the last one of
    every field but ``momentum``."""
    f = dict(generator=generator, device=device, dtype=dtype)
    return NUTSDraws(
        momentum=streams.randn((num_chains, dim), **f),
        direction=streams.rand((max_tree_depth, num_chains), chain_axis=1, **f) < 0.5,
        leaf_uniform=streams.rand((max_tree_depth, 2 ** (max_tree_depth - 1), num_chains),
                                  chain_axis=2, **f),
        bias_uniform=streams.rand((max_tree_depth, num_chains), chain_axis=1, **f),
    )


class _BTree(NamedTuple):
    # (C, D) vectors or (C,) scalars, every field chain-batched
    z_left: torch.Tensor
    r_left: torch.Tensor
    g_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    g_right: torch.Tensor
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    g_prop: torch.Tensor
    energy_prop: torch.Tensor
    r_sum: torch.Tensor
    log_weight: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor


class _PendingFlag:
    """``mask.any()``, readable later.  On a CUDA tensor the flag is copied
    to pinned host memory without blocking and an event marks the copy, so
    ``read()`` waits only for the work queued before the flag."""

    def __init__(self, mask: torch.Tensor):
        flag = mask.any()
        self._event = None
        if flag.is_cuda:
            self._host = torch.empty((), dtype=torch.bool, pin_memory=True)
            self._host.copy_(flag, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = flag

    def read(self) -> bool:
        with profiling.span("nuts.flag_wait"):
            if self._event is not None:
                self._event.synchronize()
            return bool(self._host)


def batched_init(positions: Params, value_and_grad_fn: Callable) -> NUTSState:
    """Chain-batched NUTSState: leaves carry a leading chain axis and
    ``value_and_grad_fn`` maps batched positions to ((C,) values, grads)."""
    value, grad = value_and_grad_fn(positions)
    return NUTSState(positions, value, grad)


class BatchedNUTSKernel:
    """``step(state, step_sizes, inv_mass, *, draws=None, generator=None)
    -> (state, info)``; see ``build_batched_kernel``.  ``leaves_executed``
    counts the lockstep leaves (calls of ``value_and_grad_fn``) that every
    step so far has run, masked ones included."""

    def __init__(self, value_and_grad_fn: Callable, max_tree_depth: int,
                 divergence_threshold: float, sync_lag: int):
        if max_tree_depth < 1:
            raise ValueError("max_tree_depth must be >= 1")
        if sync_lag not in (0, 1):
            raise ValueError("sync_lag must be 0 or 1")
        self.value_and_grad_fn = value_and_grad_fn
        self.max_tree_depth = int(max_tree_depth)
        self.divergence_threshold = float(divergence_threshold)
        self.sync_lag = sync_lag
        self.leaves_executed = 0

    def __call__(self, state: NUTSState, step_sizes: torch.Tensor,
                 inv_mass: Optional[Params], *, draws: Optional[NUTSDraws] = None,
                 generator: Optional[torch.Generator] = None):
        with contextlib.ExitStack() as phase:
            return self._step(phase, state, step_sizes, inv_mass, draws, generator)

    def _step(self, phase: contextlib.ExitStack, state: NUTSState, step_sizes: torch.Tensor,
              inv_mass: Optional[Params], draws: Optional[NUTSDraws],
              generator: Optional[torch.Generator]):
        # The step's host phases are spans (utils/profiling.py), none inside
        # another, and ``phase`` holds the open one: nuts.begin up to the
        # first leaf; a leaf's nuts.flag_wait (in _PendingFlag.read: the host
        # blocked on the card), then its nuts.leaf (the leaf's enqueue, ending
        # with the next leaf's flag); each depth's nuts.merge (the subtree
        # merged into the tree, then the next subtree's start and first flag,
        # or the step's result).
        phase.enter_context(profiling.span("nuts.begin"))
        max_depth = self.max_tree_depth
        z0, unravel = tree_batch_ravel(state.position)              # (C, D)
        g0, _ = tree_batch_ravel(state.logdensity_grad)
        num_chains, dim = z0.shape
        im = torch.ones_like(z0) if inv_mass is None else tree_batch_ravel(inv_mass)[0]
        if draws is None:
            if generator is None:
                raise ValueError("pass draws= or an explicit generator=")
            draws = sample_draws(num_chains, dim, max_depth, generator, z0.device, z0.dtype)
        eps = torch.as_tensor(step_sizes, dtype=z0.dtype, device=z0.device)   # (C,)

        def vag_flat(z):
            v, g = self.value_and_grad_fn(unravel(z))
            return v, tree_batch_ravel(g)[0]

        def kinetic(r):
            return 0.5 * (im * r * r).sum(dim=1)                     # (C,)

        def is_turning(r_left, r_right, rho):
            # Betancourt's criterion, boundary momenta at weight 1/2
            rho = rho - 0.5 * (r_left + r_right)
            dl = (im * r_left * rho).sum(dim=1)
            dr = (im * r_right * rho).sum(dim=1)
            return (dl <= 0.0) | (dr <= 0.0)                         # (C,)

        r0 = torch.sqrt(1.0 / im) * draws.momentum
        energy0 = -state.logdensity + kinetic(r0)                    # (C,)

        zeros_c = torch.zeros_like(energy0)
        false_c = torch.zeros_like(energy0, dtype=torch.bool)
        int_c = torch.zeros_like(energy0, dtype=torch.int32)
        tree = _BTree(z0, r0, g0, z0, r0, g0, z0, state.logdensity, g0, energy0,
                      r0, zeros_c, zeros_c, int_c, false_c, false_c)
        chain_depth = int_c
        # checkpoint buffers, one slot per depth; a slot is written by an even
        # leaf and read by later odd leaves of the same subtree, and a stale
        # slot is only ever read for a masked chain, whose result is dropped
        r_ck = torch.zeros((num_chains, max_depth + 1, dim), dtype=z0.dtype, device=z0.device)
        rs_ck = torch.zeros_like(r_ck)
        pending = None
        stop = False

        for depth in range(max_depth):
            active = ~(tree.diverging | tree.turning)                 # (C,)
            activec = active[:, None]
            pos = draws.direction[depth]                              # (C,)
            posc = pos[:, None]
            direction = torch.where(pos, 1.0, -1.0).to(z0.dtype)
            e = (direction * eps)[:, None]                            # (C, 1)

            # the subtree's carry, starting from the edge it extends
            z = torch.where(posc, tree.z_right, tree.z_left)
            r = torch.where(posc, tree.r_right, tree.r_left)
            g = torch.where(posc, tree.g_right, tree.g_left)
            z_prop, g_prop = z, g
            logp_prop = torch.full_like(zeros_c, -float("inf"))
            energy_prop = torch.full_like(zeros_c, float("inf"))
            r_sum = torch.zeros_like(r)
            log_weight = torch.full_like(zeros_c, -float("inf"))
            sum_accept, num_leaves = zeros_c, int_c
            diverging, turning = false_c, false_c
            mask = active & ~(diverging | turning)                    # (C,)
            flag = _PendingFlag(mask)

            for i in range(2 ** depth):
                phase.close()
                if self.sync_lag == 0:
                    if not flag.read():
                        stop = True
                        break
                else:
                    # the previous leaf's flag: if it was all-masked, so is
                    # this one and every later one
                    if pending is not None and not pending.read():
                        stop = True
                        break
                    pending = flag
                phase.enter_context(profiling.span("nuts.leaf"))
                self.leaves_executed += 1
                maskc = mask[:, None]

                r_new = r + 0.5 * e * g
                z_new = z + e * im * r_new
                v_new, g_new = vag_flat(z_new)
                r_new = r_new + 0.5 * e * g_new
                # terminated chains stay at their last valid state, so the
                # next (wasted) lockstep leaf integrates finite values
                z = torch.where(maskc, z_new, z)
                r = torch.where(maskc, r_new, r)
                g = torch.where(maskc, g_new, g)

                energy = -v_new + kinetic(r_new)
                energy = torch.where(torch.isnan(energy), float("inf"), energy)
                delta = energy0 - energy
                div_new = -delta > self.divergence_threshold
                accept = torch.clamp(torch.exp(delta), max=1.0)

                # progressive multinomial proposal within the subtree
                new_total = torch.logaddexp(log_weight, delta)
                p_take = torch.exp(delta - new_total)
                take = (draws.leaf_uniform[depth, i] < p_take) & mask
                takec = take[:, None]
                z_prop = torch.where(takec, z, z_prop)
                logp_prop = torch.where(take, v_new, logp_prop)
                g_prop = torch.where(takec, g, g_prop)
                energy_prop = torch.where(take, energy, energy_prop)
                r_sum = torch.where(maskc, r_sum + r, r_sum)

                # trailing-bits checkpoints: even leaves store, odd leaves check
                idx_max = _bit_count(i >> 1)
                turn_new = false_c
                if i % 2 == 0:
                    r_ck[:, idx_max] = torch.where(maskc, r, r_ck[:, idx_max])
                    rs_ck[:, idx_max] = torch.where(maskc, r_sum, rs_ck[:, idx_max])
                else:
                    idx_min = idx_max - _trailing_ones(i) + 1
                    for j in range(idx_max, idx_min - 1, -1):
                        rho = r_sum - rs_ck[:, j] + r_ck[:, j]
                        turn_new = turn_new | is_turning(r_ck[:, j], r, rho)
                    turn_new = turn_new & ~div_new

                log_weight = torch.where(mask, new_total, log_weight)
                sum_accept = torch.where(mask, sum_accept + accept, sum_accept)
                num_leaves = num_leaves + mask.to(torch.int32)
                diverging = torch.where(mask, div_new, diverging)
                turning = torch.where(mask, turn_new, turning)
                if i + 1 < 2 ** depth:
                    mask = active & ~(diverging | turning)
                    flag = _PendingFlag(mask)

            phase.close()
            phase.enter_context(profiling.span("nuts.merge"))
            # merge the subtree into the tree (the JAX outer loop's body)
            z_left = torch.where(posc, tree.z_left, z)
            r_left = torch.where(posc, tree.r_left, r)
            g_left = torch.where(posc, tree.g_left, g)
            z_right = torch.where(posc, z, tree.z_right)
            r_right = torch.where(posc, r, tree.r_right)
            g_right = torch.where(posc, g, tree.g_right)

            # biased progressive sampling across subtrees
            p_take = torch.exp(torch.clamp(log_weight - tree.log_weight, max=0.0))
            take = (draws.bias_uniform[depth] < p_take) & ~(diverging | turning) & active
            takec = take[:, None]
            r_sum_all = torch.where(activec, tree.r_sum + r_sum, tree.r_sum)
            full_turning = is_turning(r_left, r_right, r_sum_all)
            tree = _BTree(
                z_left=torch.where(activec, z_left, tree.z_left),
                r_left=torch.where(activec, r_left, tree.r_left),
                g_left=torch.where(activec, g_left, tree.g_left),
                z_right=torch.where(activec, z_right, tree.z_right),
                r_right=torch.where(activec, r_right, tree.r_right),
                g_right=torch.where(activec, g_right, tree.g_right),
                z_prop=torch.where(takec, z_prop, tree.z_prop),
                logp_prop=torch.where(take, logp_prop, tree.logp_prop),
                g_prop=torch.where(takec, g_prop, tree.g_prop),
                energy_prop=torch.where(take, energy_prop, tree.energy_prop),
                r_sum=r_sum_all,
                log_weight=torch.where(active, torch.logaddexp(tree.log_weight, log_weight),
                                       tree.log_weight),
                sum_accept=torch.where(active, tree.sum_accept + sum_accept, tree.sum_accept),
                num_leaves=tree.num_leaves + torch.where(active, num_leaves, 0),
                diverging=torch.where(active, diverging, tree.diverging),
                turning=torch.where(active, turning | full_turning, tree.turning),
            )
            chain_depth = torch.where(active, depth + 1, chain_depth).to(torch.int32)
            if stop:
                break

        accepted = (tree.z_prop != z0).any(dim=1)
        new_state = NUTSState(unravel(tree.z_prop), tree.logp_prop, unravel(tree.g_prop))
        info = NUTSInfo(
            acceptance_prob=tree.sum_accept / torch.clamp(tree.num_leaves.to(z0.dtype), min=1.0),
            is_accepted=accepted,
            energy=tree.energy_prop,
            is_divergent=tree.diverging,
            num_integration_steps=tree.num_leaves,
            depth=chain_depth,
        )
        return new_state, info


def build_batched_kernel(value_and_grad_fn: Callable, max_tree_depth: int = 10,
                         divergence_threshold: float = 1000.0,
                         sync_lag: int = 1) -> BatchedNUTSKernel:
    """Returns ``step(state, step_sizes, inv_mass, *, draws=None,
    generator=None) -> (state, info)``.

    ``value_and_grad_fn``: chain-batched positions (leaves (C, ...)) ->
    ((C,) log densities, batched grads); every lockstep leaf is one call.
    ``step_sizes`` is (C,); ``inv_mass`` a chain-batched diagonal inverse
    mass (leaves (C, ...)) or None for identity (whitened coordinates).
    Info fields are (C,) vectors: ``num_integration_steps`` is a chain's
    tree size, ``depth`` the doubling at which its tree stopped.
    ``sync_lag``: see the module docstring.
    """
    return BatchedNUTSKernel(value_and_grad_fn, max_tree_depth, divergence_threshold,
                             sync_lag)
