"""Parity of the port's dual averaging, Welford accumulator, window
schedule, step-size search and warmup loop with JAX.

Fed the same acceptance sequence, the per-chain dual-averaging states agree
to rtol 1e-6 (the same f32 arithmetic in the same order).  The Welford
inverse mass agrees with JAX's and with numpy's variance to rtol 1e-5, and a
150-step ``run_warmup(adapt_mass=True)`` fed a fixed table of acceptance
probabilities and positions gives JAX's step size and inverse mass at every
step (rtol 1e-5, the tolerance of ``exp`` across the two compilers).
"""

from typing import Any, NamedTuple

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference.warmup import (  # noqa: E402
    build_schedule as jax_build_schedule,
    run_warmup as jax_run_warmup,
)
from dropout_hamiltonian_montecarlo_tpu.models import MVNGaussian as JaxMVN  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import adaptation as jad  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.metrics import unit_metric as jax_unit_metric  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.warmup import (  # noqa: E402
    build_schedule,
    run_warmup,
)
from dropout_hamiltonian_montecarlo_tpu_torch.models import MVNGaussian  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import adaptation as tad  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.metrics import unit_metric  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402

T, C = 120, 5


def _acceptance(seed):
    return np.random.RandomState(seed).uniform(0.0, 1.0, size=(T, C)).astype(np.float32)


@pytest.mark.parametrize("target", [0.5, 0.8])
def test_dual_averaging_sequence_matches_jax(target):
    acc = _acceptance(0)
    eps0 = np.linspace(0.05, 0.5, C).astype(np.float32)
    jda = jad.dual_averaging_init(jnp.asarray(eps0))
    tda = tad.dual_averaging_init(torch.from_numpy(eps0))
    for t in range(T):
        jda = jad.dual_averaging_update(jda, jnp.asarray(acc[t]), target)
        tda = tad.dual_averaging_update(tda, torch.from_numpy(acc[t]), target)
        for field in tad.DualAveragingState._fields:
            np.testing.assert_allclose(getattr(tda, field).numpy(),
                                       np.asarray(getattr(jda, field)), rtol=1e-6,
                                       err_msg=f"step {t} field {field}")


class _State(NamedTuple):
    position: Any
    t: Any


class _Info(NamedTuple):
    acceptance_prob: Any


def test_run_warmup_matches_jax_on_scripted_kernel():
    """A kernel that replays a fixed acceptance table: the step sizes the
    warmup hands it, and the adapted step size, match JAX's run_warmup."""
    acc = _acceptance(1)

    def jax_kernel(key, state, step_size, inv_mass):
        return _State(state.position, state.t + 1), _Info(jnp.asarray(acc)[state.t])

    def torch_kernel(state, step_size, inv_mass, generator=None):
        return _State(state.position, state.t + 1), _Info(torch.from_numpy(acc[state.t]))

    eps0 = np.full((C,), 0.1, np.float32)
    jres = jax_run_warmup(jax_kernel, _State({"x": jnp.zeros((C,))}, jnp.int32(0)),
                          jax.random.key(0), T, initial_step_size=jnp.asarray(eps0),
                          target_acceptance=0.5, adapt_mass=False)
    tres = run_warmup(torch_kernel, _State({"x": torch.zeros(C)}, 0), T,
                      initial_step_size=torch.from_numpy(eps0),
                      target_acceptance=0.5, adapt_mass=False)

    # step sizes pass through exp(), which XLA's compiled scan evaluates a
    # few ulp away from torch's: rtol 1e-5 here, 1e-6 on the states above
    np.testing.assert_allclose(tres.step_size.numpy(), np.asarray(jres.step_size),
                               rtol=1e-5)
    np.testing.assert_allclose(tres.info[1].numpy(), np.asarray(jres.info[1]), rtol=1e-5)
    np.testing.assert_allclose(tres.info[0].acceptance_prob.numpy(), acc)
    assert tres.state.t == T
    assert set(tres.inv_mass) == {"x"} and bool((tres.inv_mass["x"] == 1).all())


def test_mass_adaptation_is_not_ported():
    """Mass adaptation is ``run_warmup``'s default and runs: on a kernel that
    replays positions of per-coordinate scale (1, 3), the adapted inverse
    mass moves off the identity towards the variances (1, 9)."""
    rng = np.random.RandomState(2)
    table = torch.from_numpy((rng.randn(200, C, 2) * np.array([1.0, 3.0])).astype(np.float32))

    def kernel(state, step_size, inv_mass, generator=None):
        return _State({"x": table[state.t]}, state.t + 1), _Info(torch.full((C,), 0.8))

    res = run_warmup(kernel, _State({"x": torch.zeros(C, 2)}, 0), 200,
                     initial_step_size=torch.full((C,), 0.1))
    im = res.inv_mass["x"]
    assert im.shape == (C, 2)
    assert bool((im[:, 1] > 3 * im[:, 0]).all()) and bool((im[:, 1] > 4.0).all())


@pytest.mark.parametrize("num_steps", [1000, 150, 30, 10])
def test_build_schedule_matches_jax(num_steps):
    got, ref = build_schedule(num_steps), jax_build_schedule(num_steps)
    for g, r in zip(got, ref):
        assert g.dtype == bool and g.shape == (num_steps,)
        np.testing.assert_array_equal(g, r)
    if num_steps >= 20:
        assert got[1].sum() >= 1 and got[0][got[1]].all()


def test_welford_matches_numpy_and_jax():
    """Per-chain accumulators: each chain's inverse mass is its own sample
    variance (numpy, ddof 1) under the Stan shrinkage, and equals JAX's
    ``welford_inv_mass`` of that chain."""
    rng = np.random.RandomState(3)
    n = 40
    samples = {"w": (rng.randn(n, C, 3) * np.array([0.5, 1.0, 4.0])).astype(np.float32),
               "b": rng.randn(n, C).astype(np.float32) + 2.0}
    wf = tad.welford_init({k: torch.from_numpy(v[0]) for k, v in samples.items()})
    for t in range(n):
        wf = tad.welford_update(wf, {k: torch.from_numpy(v[t]) for k, v in samples.items()})
    assert wf.count == n
    raw = tad.welford_inv_mass(wf, regularize=False)
    reg = tad.welford_inv_mass(wf)
    for k, v in samples.items():
        var = v.var(axis=0, ddof=1)
        np.testing.assert_allclose(raw[k].numpy(), var, rtol=1e-5)
        np.testing.assert_allclose(reg[k].numpy(), (n / (n + 5.0)) * var + 1e-3 * 5.0 / (n + 5.0),
                                   rtol=1e-5)
    for c in range(C):
        jwf = jad.welford_init({k: jnp.asarray(v[0, c]) for k, v in samples.items()})
        for t in range(n):
            jwf = jad.welford_update(jwf, {k: jnp.asarray(v[t, c]) for k, v in samples.items()})
        jim = jad.welford_inv_mass(jwf)
        for k in samples:
            np.testing.assert_allclose(reg[k][c].numpy(), np.asarray(jim[k]), rtol=1e-5)
        # the converter gives the port's state for one JAX chain
        one = params_from_jax(jwf, "cpu", add_chain_axis=True)
        assert isinstance(one, tad.WelfordState) and one.count == n
        np.testing.assert_allclose(one.mean["w"][0].numpy(), wf.mean["w"][c].numpy(), rtol=1e-5)


class _MassInfo(NamedTuple):
    acceptance_prob: Any
    inv_mass: Any


@pytest.mark.parametrize("steps, windows", [(150, 1), (400, 3)])
def test_window_warmup_matches_jax_step_by_step(steps, windows):
    """``run_warmup(adapt_mass=True)`` on kernels that replay a table of
    acceptance probabilities and of positions (draws of a 2-D MVN, a
    different scale per chain): the step size handed to the kernel and the
    inverse mass in force agree with the JAX scan at every step, through
    every window end with its dual-averaging restart."""
    rng = np.random.RandomState(4)
    # centred on the target, so the log step stays O(1) and exp() keeps rtol 1e-5
    acc = np.clip(0.8 + 0.15 * rng.randn(steps, C), 0.0, 1.0).astype(np.float32)
    chol = np.linalg.cholesky(np.array([[1.5, 0.5], [0.5, 1.5]]))
    pos = (rng.randn(steps, C, 2) @ chol.T * np.linspace(0.5, 2.0, C)[None, :, None]) \
        .astype(np.float32)
    is_middle, window_end = build_schedule(steps)
    assert window_end.sum() == windows and is_middle.sum() >= 25

    def jax_kernel(table_acc, table_pos):
        def kernel(key, state, step_size, inv_mass):
            return (_State({"x": table_pos[state.t]}, state.t + 1),
                    _MassInfo(table_acc[state.t], inv_mass["x"]))
        return kernel

    def one_chain(table_acc, table_pos):
        res = jax_run_warmup(jax_kernel(table_acc, table_pos),
                             _State({"x": jnp.zeros((2,))}, jnp.int32(0)), jax.random.key(0),
                             steps, initial_step_size=0.2, target_acceptance=0.8)
        return res.step_size, res.inv_mass["x"], res.info[0].inv_mass, res.info[1]

    j_step, j_im, j_im_seq, j_step_seq = jax.vmap(one_chain, in_axes=(1, 1))(
        jnp.asarray(acc), jnp.asarray(pos))

    tpos = torch.from_numpy(pos)

    def torch_kernel(state, step_size, inv_mass, generator=None):
        return (_State({"x": tpos[state.t]}, state.t + 1),
                _MassInfo(torch.from_numpy(acc[state.t]), inv_mass["x"]))

    res = run_warmup(torch_kernel, _State({"x": torch.zeros(C, 2)}, 0), steps,
                     initial_step_size=torch.full((C,), 0.2), target_acceptance=0.8)
    np.testing.assert_allclose(res.info[1].numpy(), np.asarray(j_step_seq).T, rtol=1e-5)
    np.testing.assert_allclose(res.info[0].inv_mass.numpy(),
                               np.swapaxes(np.asarray(j_im_seq), 0, 1), rtol=1e-5)
    np.testing.assert_allclose(res.step_size.numpy(), np.asarray(j_step), rtol=1e-5)
    np.testing.assert_allclose(res.inv_mass["x"].numpy(), np.asarray(j_im), rtol=1e-5)
    # the mass changed at each window end, and the step restarted there
    changed = (res.info[0].inv_mass[1:] != res.info[0].inv_mass[:-1]).any(dim=(1, 2)).numpy()
    np.testing.assert_array_equal(np.nonzero(changed)[0], np.nonzero(window_end)[0])


def test_find_reasonable_step_size_matches_jax():
    """Every chain's search, with the JAX momentum draw injected: chains far
    out halve, chains near the mode double, each ends on JAX's power of two."""
    mu = np.array([1.0, -2.0], np.float32)
    cov = np.array([[1.5, 0.5], [0.5, 1.5]], np.float32)
    jld = JaxMVN(mu, cov).make_logdensity()
    tld = MVNGaussian(mu, cov).make_logdensity()
    rng = np.random.RandomState(5)
    pos = (mu + rng.randn(6, 2) * np.array([0.1, 0.1, 1.0, 1.0, 30.0, 100.0])[:, None]) \
        .astype(np.float32)
    tpos = {"x": torch.from_numpy(pos)}
    for eps0 in (1.0, 1e-3):
        j_eps, momenta = [], []
        for c in range(6):
            key = jax.random.key(20 + c)
            p = {"x": jnp.asarray(pos[c])}
            j_eps.append(float(jad.find_reasonable_step_size(
                key, jld, jax_unit_metric(p), p, initial_step_size=eps0)))
            momenta.append(np.asarray(jax_unit_metric(p).sample_momentum(key, p)["x"]))
        t_eps = tad.find_reasonable_step_size(
            tld, unit_metric(tpos), tpos, initial_step_size=eps0,
            momentum={"x": torch.from_numpy(np.stack(momenta))})
        np.testing.assert_allclose(t_eps.numpy(), np.array(j_eps, np.float32), rtol=1e-6)
    assert len(set(t_eps.tolist())) > 1
    with pytest.raises(ValueError, match="Generator"):
        tad.find_reasonable_step_size(tld, unit_metric(tpos), tpos)
