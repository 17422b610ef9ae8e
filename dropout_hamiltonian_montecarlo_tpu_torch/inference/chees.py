"""ChEES-HMC: cross-chain adaptation of the step size and trajectory length.

The Change-in-the-Estimator-of-the-Expected-Square criterion of Hoffman,
Radul & Sountsov (AISTATS 2021),

    ChEES(T) = (1/4) E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ],

is ascended in log T with Adam, E[.] being the mean over the chain axis of
the chain-batched state.  Each adaptation step:

  1. a quasi-random jitter h_m (Halton, base 2) shared by all chains sets
     the leapfrog count L = ceil(h_m T / eps), read to the host (the one
     sync of the step), and every chain integrates L steps;
  2. d ChEES / d log T is estimated from the trajectory endpoints,
     dq'/dT = h_m v' (v' = M^-1 p'), each chain weighted by its MH
     acceptance probability;
  3. the shared step size adapts by dual averaging on the harmonic-mean
     acceptance.

Works on any chain-batched value_and_grad (the fused softmax-GLM path
included); in whitened coordinates the inverse mass is 1.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import streams
from ..ops.adaptation import dual_averaging_init, dual_averaging_update
from ..ops.integrators import IntegratorState, trajectory, velocity_verlet_batched
from ..ops.metrics import batched_diagonal_metric
from ..ops.tree import Params, tree_ones_like, tree_where_bcast
from .hmc import HMCState


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor


def _adam_init(device=None) -> AdamState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return AdamState(z, z, z)


def _adam_update(state: AdamState, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    count = state.count + 1.0
    m = b1 * state.m + (1.0 - b1) * grad
    v = b2 * state.v + (1.0 - b2) * grad * grad
    mhat = m / (1.0 - b1 ** count)
    vhat = v / (1.0 - b2 ** count)
    return AdamState(m, v, count), lr * mhat / (torch.sqrt(vhat) + eps)


def halton_sequence(num: int, base: int = 2) -> np.ndarray:
    """Quasi-random jitter factors in (0, 1) (radical inverse, host-side)."""
    out = np.zeros(num, np.float32)
    for i in range(num):
        f, r, n = 1.0, 0.0, i + 1
        while n > 0:
            f /= base
            r += f * (n % base)
            n //= base
        out[i] = r
    return out


class ChEESResult(NamedTuple):
    state: Any                        # final chain-batched HMCState
    step_size: torch.Tensor           # adapted shared step size (0-d)
    trajectory_length: torch.Tensor   # adapted max trajectory time T (0-d)
    num_integration_steps: int        # suggested fixed L = round(T / (2 eps))
    info: Any                         # per step: (accept mean, step size, T, L), stacked


def run_chees_warmup(
    value_and_grad_fn: Callable,
    initial_state: HMCState,
    num_steps: int,
    initial_step_size: float = 0.1,
    initial_traj_length: Optional[float] = None,
    target_acceptance: float = 0.651,
    max_leapfrog_steps: int = 256,
    learning_rate: float = 0.025,
    inv_mass: Optional[Params] = None,
    divergence_threshold: float = 1000.0,
    *,
    generator: torch.Generator,
) -> ChEESResult:
    """Joint (step size, trajectory length) adaptation over a chain ensemble.

    ``value_and_grad_fn``: chain-batched positions -> ((C,) values, grads),
    the callable hmc.build_batched_kernel takes.  ``initial_state`` is a
    batched HMCState (hmc.batched_init).  ONE (eps, T) pair is adapted for
    the whole ensemble.  Momenta and accept uniforms come from
    ``generator``."""
    positions = initial_state.position
    if inv_mass is None:
        inv_mass = tree_ones_like(positions)
    metric = batched_diagonal_metric(inv_mass)
    num_chains = initial_state.logdensity.shape[0]
    device = initial_state.logdensity.device
    f32 = dict(dtype=torch.float32, device=device)

    halton = torch.as_tensor(halton_sequence(num_steps), **f32)
    t0 = initial_traj_length if initial_traj_length is not None else 10.0 * initial_step_size
    da = dual_averaging_init(torch.tensor(initial_step_size, **f32))
    adam = _adam_init(device)
    log_T = torch.log(torch.tensor(t0, **f32))
    integ = velocity_verlet_batched(value_and_grad_fn, metric.kinetic_grad)
    state = initial_state
    infos = []

    for m in range(int(num_steps)):
        eps = torch.exp(da.log_step)
        T = torch.exp(log_T)
        # jittered trajectory time shared by all chains; the leapfrog count
        # is a host int (the step's one sync)
        t_jit = halton[m] * T
        n_steps = int(torch.clamp(torch.ceil(t_jit / eps), 1, max_leapfrog_steps))

        momentum = metric.sample_momentum(state.position, generator)
        energy0 = -state.logdensity + metric.kinetic_energy(momentum)
        start = IntegratorState(state.position, momentum, state.logdensity,
                                state.logdensity_grad)
        end = trajectory(integ, n_steps)(start, eps.expand(num_chains))

        energy1 = -end.logdensity + metric.kinetic_energy(end.momentum)
        delta = energy0 - energy1
        delta = torch.where(torch.isnan(delta), -float("inf"), delta)
        accept_prob = torch.clamp(torch.exp(delta), max=1.0)            # (C,)
        is_divergent = delta.abs() > divergence_threshold

        u = streams.rand(accept_prob.shape, generator=generator, **f32)
        accept = u < accept_prob
        new_state = HMCState(
            tree_where_bcast(accept, end.position, state.position),
            tree_where_bcast(accept, end.logdensity, state.logdensity),
            tree_where_bcast(accept, end.logdensity_grad, state.logdensity_grad))

        # ChEES gradient from the trajectory endpoints, both clouds centred
        # on their cross-chain means
        v_end = metric.kinetic_grad(end.momentum)                       # M^-1 p'
        ssq_q = ssq_qp = proj = 0.0
        for k in sorted(state.position):
            q = state.position[k]
            qc = q - q.mean(dim=0, keepdim=True)
            qpc = end.position[k] - end.position[k].mean(dim=0, keepdim=True)
            axes = tuple(range(1, q.dim()))
            ssq_q = ssq_q + (qc * qc).sum(dim=axes)
            ssq_qp = ssq_qp + (qpc * qpc).sum(dim=axes)
            proj = proj + (qpc * v_end[k]).sum(dim=axes)
        dchees = (ssq_qp - ssq_q) * proj                                # (C,)
        # acceptance-weighted ensemble mean; d t / d log T = t = h T
        w = accept_prob * torch.where(is_divergent, 0.0, 1.0)
        g = (w * dchees).sum() / torch.clamp(w.sum(), min=1e-6)
        g_logT = g * t_jit
        g_logT = torch.where(torch.isfinite(g_logT), g_logT, 0.0)

        adam, step = _adam_update(adam, g_logT, learning_rate)
        log_T_new = log_T + step                                        # ascent
        # keep T realizable: at most max_leapfrog_steps full steps
        log_T_new = torch.minimum(torch.maximum(log_T_new, torch.log(eps)),
                                  torch.log(0.95 * max_leapfrog_steps * eps))
        log_T = torch.where(torch.isfinite(log_T_new), log_T_new, log_T)

        # harmonic-mean acceptance -> dual averaging
        hm_accept = 1.0 / (1.0 / torch.clamp(accept_prob, min=1e-6)).mean()
        da = dual_averaging_update(da, hm_accept, target_acceptance)
        infos.append((accept_prob.mean(), torch.exp(da.log_step), torch.exp(log_T),
                      n_steps))
        state = new_state

    step_size = torch.exp(da.log_step_avg)
    T = torch.exp(log_T)
    # fixed-L sampling suggestion: the jittered scheme realizes E[t] = T/2;
    # clamped, since T was clipped against the instantaneous eps
    n_sugg = int(torch.clamp(torch.round(0.5 * T / step_size), 1.0,
                             float(max_leapfrog_steps)))
    info = (torch.stack([i[0] for i in infos]), torch.stack([i[1] for i in infos]),
            torch.stack([i[2] for i in infos]), [i[3] for i in infos]) if infos else None
    return ChEESResult(state, step_size, T, n_sugg, info)
