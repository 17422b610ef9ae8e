"""Parity of the port's ChEES warmup with the JAX package.

The Halton jitter and the Adam update are deterministic and compared
exactly / within f32 rounding.  A whole ChEES run draws its own momenta, so
it is compared statistically on the 3-d MVN of tests/test_nuts_batched.py:
the adapted step within a factor of 1.5 of JAX's, the suggested L within
+-50%.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import chees as jchees  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference import hmc as jhmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import MVNGaussian  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import chees, hmc  # noqa: E402

MU = np.array([1.0, -2.0, 0.5], np.float32)
A = np.array([[1.0, 0.0, 0.0], [0.6, 0.8, 0.0], [-0.3, 0.4, 0.9]], np.float32)
COV = (A @ A.T + 0.2 * np.eye(3)).astype(np.float32)
CHAINS, STEPS = 32, 300


def test_halton_matches_jax():
    np.testing.assert_array_equal(chees.halton_sequence(200), jchees.halton_sequence(200))
    np.testing.assert_array_equal(chees.halton_sequence(50, base=3),
                                  jchees.halton_sequence(50, base=3))


def test_adam_update_matches_jax():
    grads = np.random.RandomState(0).randn(40).astype(np.float32) * np.logspace(-3, 3, 40)
    js, ts = jchees._adam_init(), chees._adam_init()
    for g in grads.astype(np.float32):
        js, jstep = jchees._adam_update(js, jnp.float32(g), 0.025)
        ts, tstep = chees._adam_update(ts, torch.tensor(g), 0.025)
        np.testing.assert_allclose(float(tstep), float(jstep), rtol=1e-6, atol=1e-9)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_chees_mvn_matches_jax():
    pos = MU + np.random.RandomState(1).randn(CHAINS, 3).astype(np.float32)

    model = MVNGaussian(jnp.asarray(MU), jnp.asarray(COV))
    jvag = jax.vmap(jax.value_and_grad(model.make_logdensity()))
    jres = jax.jit(lambda s, k: jchees.run_chees_warmup(
        jvag, s, k, STEPS, initial_step_size=0.2, target_acceptance=0.651,
        max_leapfrog_steps=64))(jhmc.batched_init({"x": jnp.asarray(pos)}, jvag),
                                jax.random.key(2))

    prec = torch.from_numpy(np.linalg.inv(COV.astype(np.float64)).astype(np.float32))
    mu = torch.from_numpy(MU)

    def tvag(p):
        diff = p["x"] - mu
        g = -diff @ prec
        return 0.5 * (diff * g).sum(dim=1), {"x": g}

    tres = chees.run_chees_warmup(
        tvag, hmc.batched_init({"x": torch.from_numpy(pos)}, tvag), STEPS,
        initial_step_size=0.2, target_acceptance=0.651, max_leapfrog_steps=64,
        generator=torch.Generator().manual_seed(3))

    j_eps, t_eps = float(jres.step_size), float(tres.step_size)
    j_L, t_L = int(jres.num_integration_steps), tres.num_integration_steps
    assert 1 / 1.5 < t_eps / j_eps < 1.5, (t_eps, j_eps)
    assert abs(t_L - j_L) <= 0.5 * j_L, (t_L, j_L)
    assert np.isfinite(float(tres.trajectory_length))
    assert bool(torch.isfinite(tres.state.logdensity).all())
    acc, sizes, lengths, n_steps = tres.info
    assert acc.shape == sizes.shape == lengths.shape == (STEPS,) and len(n_steps) == STEPS
    assert 1 <= min(n_steps) and max(n_steps) <= 64
