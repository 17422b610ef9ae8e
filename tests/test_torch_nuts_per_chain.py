"""Parity of the port's per-chain NUTS (``nuts.build_kernel`` over an explicit
chain axis) with ``jax.vmap`` of the JAX package's per-chain kernel.

``_replay_draws`` makes every random number of one JAX step of every chain
with the key splits the JAX kernel makes (inference/nuts.py: split(key) ->
(momentum, tree) keys; per depth split(key, 4) -> (direction, subtree, bias,
next); per leaf split -> (next, multinomial)) and hands them to the port as a
``NUTSDraws``.  Both sides are f32 on the CPU: tree sizes, depths, divergence
and accept flags equal; positions, log densities and gradients within rtol
1e-4 (atol 1e-5), in parameter space also under ``metric=``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import nuts as jnuts  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import MVNGaussian as JaxMVN  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import metrics as jmetrics  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts, nuts_batched  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import MVNGaussian  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.metrics import dense_metric  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import (  # noqa: E402
    dense_metric_from_jax,
    params_from_jax,
)

MU = np.array([1.0, -2.0, 0.5], np.float32)
A = np.array([[1.0, 0.0, 0.0], [0.6, 0.8, 0.0], [-0.3, 0.4, 0.9]], np.float32)
COV = (A @ A.T + 0.2 * np.eye(3)).astype(np.float32)
C, DEPTH = 8, 6


def _replay_draws(keys, dim, max_depth):
    """Every random number of one JAX ``nuts.build_kernel`` step of each
    chain (``keys``: one key per chain), as NUTSDraws."""
    def one(key):
        k_mom, k = jax.random.split(key)
        momentum = jax.random.normal(k_mom, (dim,))
        direction, bias, leaf = [], [], []
        for d in range(max_depth):
            k_dir, k_sub, k_bias, k = jax.random.split(k, 4)
            direction.append(jax.random.bernoulli(k_dir))
            bias.append(jax.random.uniform(k_bias))
            row = []
            for _ in range(2 ** d):
                k_sub, k_mult = jax.random.split(k_sub)
                row.append(jax.random.uniform(k_mult))
            leaf.append(jnp.stack(row + [jnp.float32(0.0)] * (2 ** (max_depth - 1) - 2 ** d)))
        return momentum, jnp.stack(direction), jnp.stack(leaf), jnp.stack(bias)

    momentum, direction, leaf, bias = jax.vmap(one)(keys)
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    return nuts_batched.NUTSDraws(t(momentum), t(direction).T.contiguous(),
                                  t(leaf).permute(1, 2, 0).contiguous(), t(bias).T.contiguous())


def _problem(seed):
    jld = JaxMVN(jnp.asarray(MU), jnp.asarray(COV)).make_logdensity()
    tld = MVNGaussian(MU, COV).make_logdensity()
    pos = {"x": (MU + np.random.RandomState(seed).randn(C, 3)).astype(np.float32)}
    return jld, tld, pos


@pytest.mark.parametrize("case", ["diagonal", "dense", "dense-diverging"])
def test_one_step_matches_vmapped_jax(case):
    jld, tld, pos = _problem(0)
    inv_mass = {"x": np.tile(np.array([1.0, 0.5, 2.0], np.float32), (C, 1))}
    eps = np.linspace(0.2, 0.7, C).astype(np.float32)
    if case == "diagonal":
        jmetric = tmetric = None
    else:
        # a deliberately imperfect metric, so the whitened target is not N(0, I)
        M = np.linalg.inv(COV + 0.3 * np.diag([1.0, 0.0, 2.0])).astype(np.float32)
        jmetric = jmetrics.dense_metric(jnp.asarray(M), {"x": jnp.zeros(3)})
        tmetric = dense_metric_from_jax(*jnp.linalg.eigh(jnp.asarray(M)),
                                        {"x": torch.zeros(C, 3)})
        if case == "dense-diverging":   # unstable above ~2 in whitened coordinates
            eps = np.array([0.3, 2.5, 3.0, 4.0, 0.5, 5.0, 3.5, 6.0], np.float32)
    jkernel = jax.jit(jax.vmap(jnuts.build_kernel(jld, max_tree_depth=DEPTH, metric=jmetric)))
    tkernel = nuts.build_kernel(tld, max_tree_depth=DEPTH, metric=tmetric)

    jstate = jax.vmap(lambda q: jnuts.init(q, jld))(pos)
    tstate = nuts.init(params_from_jax(pos, "cpu"), tld)
    leaves = []
    for i in range(2):
        keys = jax.random.split(jax.random.key(40 + i), C)
        jstate, jinfo = jkernel(keys, jstate, jnp.asarray(eps), inv_mass)
        tstate, tinfo = tkernel(tstate, torch.from_numpy(eps), params_from_jax(inv_mass, "cpu"),
                                draws=_replay_draws(keys, 3, DEPTH))
        for f in ("num_integration_steps", "depth", "is_divergent", "is_accepted"):
            np.testing.assert_array_equal(getattr(tinfo, f).numpy(),
                                          np.asarray(getattr(jinfo, f)), err_msg=f)
        np.testing.assert_allclose(tinfo.acceptance_prob.numpy(),
                                   np.asarray(jinfo.acceptance_prob), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tstate.logdensity.numpy(), np.asarray(jstate.logdensity),
                                   rtol=1e-4, atol=1e-5)
        for got, ref in ((tstate.position, jstate.position),
                         (tstate.logdensity_grad, jstate.logdensity_grad)):
            np.testing.assert_allclose(got["x"].numpy(), np.asarray(ref["x"]), rtol=1e-4,
                                       atol=1e-5)
        leaves.append(tinfo.num_integration_steps.numpy())
        if case == "dense-diverging":
            assert tinfo.is_divergent.any() and not tinfo.is_divergent.all()
        else:
            assert not tinfo.is_divergent.any()
    assert len(np.unique(leaves)) > 1 and np.max(leaves) > 1
    one_state = params_from_jax(jax.tree_util.tree_map(lambda a: a[0], jstate), "cpu",
                                add_chain_axis=True)
    assert isinstance(one_state, nuts.NUTSState) and one_state.logdensity.shape == (1,)


def test_metric_keeps_the_public_state_in_parameter_space():
    """Under ``metric=`` the returned log density and gradient are those of
    the returned position, in parameter space."""
    _, tld, pos = _problem(1)
    tpos = params_from_jax(pos, "cpu")
    metric = dense_metric(np.linalg.inv(COV), tpos)
    kernel = nuts.build_kernel(tld, max_tree_depth=5, metric=metric)
    state, info = kernel(nuts.init(tpos, tld), torch.full((C,), 0.5), None,
                         generator=torch.Generator().manual_seed(0))
    fresh = nuts.init(state.position, tld)
    np.testing.assert_allclose(state.logdensity.numpy(), fresh.logdensity.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(state.logdensity_grad["x"].numpy(),
                               fresh.logdensity_grad["x"].numpy(), rtol=1e-4, atol=1e-4)
    assert bool(info.is_accepted.any())


def test_chain_does_not_depend_on_the_batch():
    """With its draws injected, a chain's tree is the same whether it grows
    among eight chains or among two."""
    _, tld, pos = _problem(2)
    tpos = params_from_jax(pos, "cpu")
    kernel = nuts.build_kernel(tld, max_tree_depth=DEPTH)
    draws = nuts_batched.sample_draws(C, 3, DEPTH, torch.Generator().manual_seed(1), "cpu")
    eps = torch.linspace(0.1, 0.8, C)
    full, full_info = kernel(nuts.init(tpos, tld), eps, None, draws=draws)
    idx = torch.tensor([5, 2])
    sub_draws = nuts_batched.NUTSDraws(draws.momentum[idx], draws.direction[:, idx],
                                       draws.leaf_uniform[:, :, idx], draws.bias_uniform[:, idx])
    sub, sub_info = kernel(nuts.init({"x": tpos["x"][idx]}, tld), eps[idx], None,
                           draws=sub_draws)
    assert torch.equal(sub.position["x"], full.position["x"][idx])
    for a, b in zip(sub_info, full_info):
        assert torch.equal(a, b[idx])


def test_metric_without_transposes_is_refused():
    _, tld, _ = _problem(3)
    from dropout_hamiltonian_montecarlo_tpu_torch.ops.metrics import unit_metric
    with pytest.raises(ValueError, match="transposes"):
        nuts.build_kernel(tld, metric=unit_metric({"x": torch.zeros(C, 3)}))
