"""Parity of the port's per-chain HMC (``hmc.build_kernel`` over an explicit
chain axis) with ``jax.vmap`` of the JAX package's per-chain kernel.

JAX's threefry streams cannot be reproduced in PyTorch, so the test makes
every random number of a JAX step with the key splits the JAX kernel makes
(inference/hmc.py: split(key, 3) -> (momentum, jitter, accept) keys;
``metric.sample_momentum`` for the momentum, a uniform for the jittered
trajectory length, a uniform for the accept) and hands them to the port as
injected draws.  Both sides are f32 on the CPU: accept flags and per-chain
trajectory lengths equal, positions and log densities within rtol 1e-5
(atol 1e-5).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import hmc as jhmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import MVNGaussian as JaxMVN  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import metrics as jmetrics  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import MVNGaussian  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.tree import tree_ones_like  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import (  # noqa: E402
    dense_metric_from_jax,
    params_from_jax,
)

MU = np.array([1.0, -2.0, 0.5], np.float32)
A = np.array([[1.0, 0.0, 0.0], [0.6, 0.8, 0.0], [-0.3, 0.4, 0.9]], np.float32)
COV = (A @ A.T + 0.2 * np.eye(3)).astype(np.float32)
C, L = 6, 8
# spread so that some chains reject (the leapfrog is unstable above ~1.2)
EPS = np.array([0.05, 0.2, 0.5, 0.9, 1.3, 1.6], np.float32)


def _problem(seed):
    jld = JaxMVN(jnp.asarray(MU), jnp.asarray(COV)).make_logdensity()
    tld = MVNGaussian(MU, COV).make_logdensity()
    pos = {"x": (MU + np.random.RandomState(seed).randn(C, 3)).astype(np.float32)}
    return jld, tld, pos


def _replay(keys, jmetric, pos):
    """The momentum, jitter uniform and accept uniform of one JAX step of
    every chain, from the chains' keys."""
    def one(key, q):
        k_mom, k_steps, k_accept = jax.random.split(key, 3)
        return (jmetric.sample_momentum(k_mom, q), jax.random.uniform(k_steps),
                jax.random.uniform(k_accept))
    mom, u_steps, u_accept = jax.vmap(one)(keys, pos)
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    return {k: t(v) for k, v in mom.items()}, t(u_steps), t(u_accept)


@pytest.mark.parametrize("metric_kind", ["diagonal", "dense"])
@pytest.mark.parametrize("jitter", [True, False], ids=["jitter", "fixed"])
def test_one_step_matches_vmapped_jax(metric_kind, jitter):
    jld, tld, pos = _problem(0)
    one = {"x": jnp.zeros(3)}
    inv_mass = {"x": np.tile(np.array([1.0, 0.5, 2.0], np.float32), (C, 1))}
    if metric_kind == "dense":
        M = np.linalg.inv(COV).astype(np.float32)
        jmetric = jmetrics.dense_metric(jnp.asarray(M), one)
        s, U = jnp.linalg.eigh(jnp.asarray(M))
        tmetric = dense_metric_from_jax(s, U, {"x": torch.zeros(C, 3)})
        replay_metric = jmetric
    else:
        jmetric = tmetric = None
        replay_metric = jmetrics.diagonal_metric({"x": jnp.asarray(inv_mass["x"][0])})
    jkernel = jhmc.build_kernel(jld, L, jitter_steps=jitter, metric=jmetric)
    tkernel = hmc.build_kernel(tld, L, jitter_steps=jitter, metric=tmetric)

    jstate = jax.vmap(lambda q: jhmc.init(q, jld))(pos)
    tstate = hmc.init(params_from_jax(pos, "cpu"), tld)
    np.testing.assert_allclose(tstate.logdensity.numpy(), np.asarray(jstate.logdensity),
                               rtol=1e-5)
    accepted, lengths = [], []
    for i in range(3):
        keys = jax.random.split(jax.random.key(30 + i), C)
        mom, u_steps, u_accept = _replay(keys, replay_metric, jstate.position)
        jstate, jinfo = jax.vmap(jkernel)(keys, jstate, jnp.asarray(EPS), inv_mass)
        tstate, tinfo = tkernel(tstate, torch.from_numpy(EPS), params_from_jax(inv_mass, "cpu"),
                                momentum=mom, uniforms=u_accept,
                                jitter_uniforms=u_steps if jitter else None)
        np.testing.assert_array_equal(tinfo.is_accepted.numpy(), np.asarray(jinfo.is_accepted))
        np.testing.assert_array_equal(tinfo.num_integration_steps.numpy(),
                                      np.asarray(jinfo.num_integration_steps))
        np.testing.assert_array_equal(tinfo.is_divergent.numpy(), np.asarray(jinfo.is_divergent))
        np.testing.assert_allclose(tinfo.acceptance_prob.numpy(),
                                   np.asarray(jinfo.acceptance_prob), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tstate.position["x"].numpy(),
                                   np.asarray(jstate.position["x"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tstate.logdensity.numpy(), np.asarray(jstate.logdensity),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tstate.logdensity_grad["x"].numpy(),
                                   np.asarray(jstate.logdensity_grad["x"]), rtol=1e-5, atol=1e-5)
        accepted.append(tinfo.is_accepted.numpy())
        lengths.append(tinfo.num_integration_steps.numpy())
    accepted = np.array(accepted)
    assert accepted.any() and not accepted.all()
    if jitter:
        assert len(np.unique(lengths)) > 2 and np.min(lengths) >= 1 and np.max(lengths) <= L
    # a JAX state of one chain converts to the port's, chain axis added
    one_state = params_from_jax(jax.tree_util.tree_map(lambda a: a[0], jstate), "cpu",
                                add_chain_axis=True)
    assert isinstance(one_state, hmc.HMCState) and one_state.position["x"].shape == (1, 3)


def _draws(seed):
    g = torch.Generator().manual_seed(seed)
    return ({"x": torch.randn((C, 3), generator=g)}, torch.rand((C,), generator=g),
            torch.rand((C,), generator=g))


def test_chain_does_not_depend_on_the_batch():
    """With its draws injected, a chain's step is the same whether it runs
    among six chains or among two."""
    _, tld, pos = _problem(1)
    kernel = hmc.build_kernel(tld, L)
    mom, u_acc, u_jit = _draws(0)
    eps = torch.from_numpy(EPS)
    full, full_info = kernel(hmc.init(params_from_jax(pos, "cpu"), tld), eps,
                             tree_ones_like(mom), momentum=mom, uniforms=u_acc,
                             jitter_uniforms=u_jit)
    idx = torch.tensor([4, 1])
    sub_pos = {"x": torch.from_numpy(pos["x"])[idx]}
    sub, sub_info = kernel(hmc.init(sub_pos, tld), eps[idx], tree_ones_like(sub_pos),
                           momentum={"x": mom["x"][idx]}, uniforms=u_acc[idx],
                           jitter_uniforms=u_jit[idx])
    assert torch.equal(sub.position["x"], full.position["x"][idx])
    assert torch.equal(sub.logdensity, full.logdensity[idx])
    for a, b in zip(sub_info, full_info):
        assert torch.equal(a, b[idx])


def test_jittered_chain_is_frozen_after_its_last_step():
    """A chain with n < L steps ends exactly where a fixed-length run of n
    steps ends, position, value and gradient alike, also when the steps it
    sits out would have left the finite range (step size 40 on this target
    overflows f32 within L steps)."""
    _, tld, pos = _problem(2)
    mom, u_acc, u_jit = _draws(1)
    u_acc = torch.zeros(C)                     # accept every finite proposal
    u_jit[0], u_jit[1] = 0.01, 0.2             # chains 0 and 1: 1 and 2 of 8 steps
    eps = torch.from_numpy(EPS).clone()
    eps[0] = 40.0
    start = hmc.init(params_from_jax(pos, "cpu"), tld)
    ones = tree_ones_like(mom)
    new, info = hmc.build_kernel(tld, L)(start, eps, ones, momentum=mom, uniforms=u_acc,
                                         jitter_uniforms=u_jit)
    n = info.num_integration_steps
    assert n[0] == 1 and n[1] == 2 and n.dtype == torch.int32
    assert bool(torch.isfinite(new.position["x"][0]).all())
    for length in sorted(set(n.tolist())):
        fixed, _ = hmc.build_kernel(tld, length, jitter_steps=False)(
            start, eps, ones, momentum=mom, uniforms=u_acc)
        rows = n == length
        for got, ref in ((new.position["x"], fixed.position["x"]),
                         (new.logdensity, fixed.logdensity),
                         (new.logdensity_grad["x"], fixed.logdensity_grad["x"])):
            assert torch.equal(got[rows], ref[rows])


def test_per_chain_kernel_needs_explicit_randomness():
    _, tld, pos = _problem(3)
    state = hmc.init(params_from_jax(pos, "cpu"), tld)
    kernel = hmc.build_kernel(tld, 2)
    mom, u_acc, _ = _draws(2)
    with pytest.raises(ValueError, match="jitter_uniforms"):
        kernel(state, torch.from_numpy(EPS), tree_ones_like(mom), momentum=mom, uniforms=u_acc)
    with pytest.raises(ValueError, match="num_integration_steps"):
        hmc.build_kernel(tld, 0)
    new, info = kernel(state, torch.from_numpy(EPS), tree_ones_like(mom),
                       generator=torch.Generator().manual_seed(0))
    assert info.num_integration_steps.shape == (C,)
