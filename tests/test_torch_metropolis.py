"""Parity of the port's random-walk Metropolis with ``jax.vmap`` of the JAX
package's per-chain kernel.

The test makes every random number of a JAX step with the key splits the JAX
kernel makes (inference/metropolis.py: split(key, 4) -> (scale, proposal,
accept, coordinate) keys) and hands them to the port as ``MHDraws``.  Both
sides are f32 on the CPU: accept flags equal, positions and log densities
within rtol 1e-5.  ``tune_scale``'s bands are exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import metropolis as jmh  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import MVNGaussian as JaxMVN  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import metropolis  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import MVNGaussian  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402

MU = np.array([1.0, -2.0, 0.5], np.float32)
A = np.array([[1.0, 0.0, 0.0], [0.6, 0.8, 0.0], [-0.3, 0.4, 0.9]], np.float32)
COV = (A @ A.T + 0.2 * np.eye(3)).astype(np.float32)
C = 6


def _problem(seed):
    jld = JaxMVN(jnp.asarray(MU), jnp.asarray(COV)).make_logdensity()
    tld = MVNGaussian(MU, COV).make_logdensity()
    pos = {"x": (MU + np.random.RandomState(seed).randn(C, 3)).astype(np.float32)}
    return jld, tld, pos


def _replay(keys, coordinate_wise):
    def one(key):
        k_scale, k_prop, k_accept, k_coord = jax.random.split(key, 4)
        log_factor = jax.random.uniform(k_scale, minval=-1.0, maxval=1.0)
        if coordinate_wise:
            noise = jnp.zeros(3).at[0].set(jax.random.normal(k_prop))
        else:   # tree_randn_like: one split key per leaf
            noise = jax.random.normal(jax.random.split(k_prop, 1)[0], (3,))
        return (log_factor, noise, jax.random.randint(k_coord, (), 0, 3),
                jax.random.uniform(k_accept))
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    lf, noise, coord, u = jax.vmap(one)(keys)
    return metropolis.MHDraws(t(lf), t(noise), t(coord).to(torch.int64), t(u))


@pytest.mark.parametrize("jitter_scale", [True, False], ids=["jitter", "plain"])
@pytest.mark.parametrize("coordinate_wise", [False, True], ids=["full", "coordinate"])
def test_one_step_matches_vmapped_jax(jitter_scale, coordinate_wise):
    jld, tld, pos = _problem(0)
    scale = np.linspace(0.1, 2.5, C).astype(np.float32)
    jkernel = jax.vmap(jmh.build_kernel(jld, jitter_scale, coordinate_wise))
    tkernel = metropolis.build_kernel(tld, jitter_scale, coordinate_wise)
    jstate = jax.vmap(lambda q: jmh.init(q, jld))(pos)
    tstate = metropolis.init(params_from_jax(pos, "cpu"), tld)
    accepted = []
    for i in range(4):
        keys = jax.random.split(jax.random.key(50 + i), C)
        before = tstate.position["x"].clone()
        jstate, jinfo = jkernel(keys, jstate, jnp.asarray(scale))
        tstate, tinfo = tkernel(tstate, torch.from_numpy(scale),
                                draws=_replay(keys, coordinate_wise))
        np.testing.assert_array_equal(tinfo.is_accepted.numpy(), np.asarray(jinfo.is_accepted))
        np.testing.assert_allclose(tinfo.acceptance_prob.numpy(),
                                   np.asarray(jinfo.acceptance_prob), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tstate.position["x"].numpy(),
                                   np.asarray(jstate.position["x"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tstate.logdensity.numpy(), np.asarray(jstate.logdensity),
                                   rtol=1e-5, atol=1e-6)
        if coordinate_wise:   # an accepted move changes exactly one coordinate
            moved = (tstate.position["x"] != before).sum(dim=1)
            assert bool((moved == tinfo.is_accepted.to(moved.dtype)).all())
        accepted.append(tinfo.is_accepted.numpy())
    accepted = np.array(accepted)
    assert accepted.any() and not accepted.all()
    one_state = params_from_jax(jax.tree_util.tree_map(lambda a: a[0], jstate), "cpu",
                                add_chain_axis=True)
    assert isinstance(one_state, metropolis.MHState) and one_state.logdensity.shape == (1,)


def test_tune_scale_bands_are_exact():
    rates = np.array([0.0, 0.0005, 0.001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.5, 0.51, 0.75, 0.76,
                      0.95, 0.96, 1.0], np.float32)
    scale = np.linspace(0.5, 2.0, rates.size).astype(np.float32)
    got = metropolis.tune_scale(torch.from_numpy(scale), torch.from_numpy(rates)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmh.tune_scale(jnp.asarray(scale),
                                                                 jnp.asarray(rates))))
    factors = got / scale
    np.testing.assert_allclose(factors, [0.1, 0.1, 0.5, 0.5, 0.9, 0.9, 1.0, 1.0, 1.0, 1.1, 1.1,
                                         2.0, 2.0, 10.0, 10.0], rtol=1e-6)


def test_warmup_scale_then_sampling_recovers_the_mvn():
    """Per-chain scale tuning settles every chain's acceptance inside the
    untouched band, and the tuned chains recover the target's moments."""
    _, tld, _ = _problem(1)
    chains = 16
    gen = torch.Generator().manual_seed(0)
    kernel = metropolis.build_kernel(tld)
    state = metropolis.init({"x": torch.from_numpy(MU) + torch.randn((chains, 3), generator=gen)},
                            tld)
    state, scale = metropolis.run_warmup_scale(kernel, state, 1500, initial_scale=20.0,
                                               tune_interval=100, generator=gen)
    assert scale.shape == (chains,) and bool((scale < 20.0).all()) and len(scale.unique()) > 1
    xs, acc = [], []
    for _ in range(3000):
        state, info = kernel(state, scale, generator=gen)
        xs.append(state.position["x"])
        acc.append(info.is_accepted)
    rate = torch.stack(acc).float().mean(dim=0)
    assert bool(((rate > 0.1) & (rate < 0.8)).all()), rate
    flat = torch.stack(xs).reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), MU, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.25)


def test_kernel_needs_explicit_randomness():
    _, tld, pos = _problem(2)
    state = metropolis.init(params_from_jax(pos, "cpu"), tld)
    with pytest.raises(ValueError, match="generator"):
        metropolis.build_kernel(tld)(state, 0.5)
