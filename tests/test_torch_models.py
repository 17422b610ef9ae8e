"""Parity of the port's small models and utilities with the JAX package.

The same numpy inputs go through both packages.  Values, ``analytic_grad``
and the port's autograd gradient agree with the JAX model's value and
``jax.grad`` within rtol 1e-5 (both f32 on the CPU, differing only in
summation order; atol 1e-5 for gradient entries near zero).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu import models as jmodels  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu import utils as jutils  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import models as tmodels  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import utils as tutils  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.integrators import (  # noqa: E402
    lift_value_and_grad,
)

RTOL, ATOL = 1e-5, 1e-5


def _case(name):
    """(jax model, port model, one chain's params, batch), all numpy."""
    rng = np.random.RandomState(0)
    if name == "gaussian":
        mu, sigma = np.array([0.5, -1.0, 2.0], np.float32), np.array([1.0, 0.5, 2.0], np.float32)
        return (jmodels.Gaussian(mu, sigma, dim=3), tmodels.Gaussian(mu, sigma, dim=3),
                {"x": rng.randn(3).astype(np.float32)}, None)
    if name == "mvn":
        mu = np.array([1.0, -2.0, 0.5], np.float32)
        a = rng.randn(3, 3).astype(np.float32)
        cov = a @ a.T + 0.5 * np.eye(3, dtype=np.float32)
        return (jmodels.MVNGaussian(mu, cov), tmodels.MVNGaussian(mu, cov),
                {"x": rng.randn(3).astype(np.float32)}, None)
    X = rng.randn(200, 5).astype(np.float32)
    params = {"weights": (0.3 * rng.randn(5)).astype(np.float32),
              "bias": np.float32(0.2)}
    if name == "logistic":
        y = (rng.rand(200) < 0.5).astype(np.float32)
        return (jmodels.Logistic(dim=5, alpha=0.1), tmodels.Logistic(dim=5, alpha=0.1),
                params, (X, y))
    y = rng.poisson(2.0, size=200).astype(np.float32)
    return (jmodels.Poisson(dim=5, alpha=0.1), tmodels.Poisson(dim=5, alpha=0.1),
            params, (X, y))


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _tb(batch):
    return None if batch is None else tuple(torch.from_numpy(b) for b in batch)


CASES = ["gaussian", "mvn", "logistic", "poisson"]


@pytest.mark.parametrize("name", CASES)
def test_value_and_analytic_grad_match_jax(name):
    jm, tm, params, batch = _case(name)
    jld = jm.make_logdensity(batch)
    jv, jg = jax.value_and_grad(jld)(params)
    tld = tm.make_logdensity(_tb(batch))
    tparams = _t(params)
    np.testing.assert_allclose(float(tld(tparams)), float(jv), rtol=RTOL)
    np.testing.assert_allclose(float(tm.potential(tparams, _tb(batch))), -float(jv), rtol=RTOL)
    tg = tm.analytic_grad(tparams, _tb(batch))
    jag = jm.analytic_grad(params, batch)
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jag[k]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_lifted_autograd_matches_analytic_grad_and_jax(name):
    """The chain-batched value+grad (vmap of grad_and_value) over 3 chains
    against the analytic gradient of each chain and ``jax.vmap``."""
    jm, tm, params, batch = _case(name)
    rng = np.random.RandomState(1)
    stacked = {k: (np.asarray(v)[None] + 0.1 * rng.randn(3, *np.shape(v))).astype(np.float32)
               for k, v in params.items()}
    jv, jg = jax.vmap(jax.value_and_grad(jm.make_logdensity(batch)))(stacked)
    tv, tg = lift_value_and_grad(tm.make_logdensity(_tb(batch)))(_t(stacked))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    for c in range(3):
        ag = tm.analytic_grad({k: torch.as_tensor(v[c]) for k, v in stacked.items()},
                              _tb(batch))
        for k in params:
            np.testing.assert_allclose(tg[k][c].numpy(), ag[k].numpy(), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(tg[k][c].numpy(), np.asarray(jg[k][c]), rtol=RTOL,
                                       atol=ATOL)


def test_minibatch_scaling_and_batched_logdensity():
    jm, tm, params, batch = _case("logistic")
    mini = tuple(b[:50] for b in batch)
    jv = jm.make_batched_logdensity(data_size=200)(params, mini)
    tv = tm.make_batched_logdensity(data_size=200)(_t(params), _tb(mini))
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)


def test_glm_likelihoods_stay_finite_at_large_logits():
    """softplus / exp forms: a logit of +-80 gives a finite f32 log density
    and gradient (log(1 + exp(80)) would overflow)."""
    X = torch.tensor([[80.0], [-80.0]])
    start = {"weights": torch.ones(1, 1), "bias": torch.zeros(1)}
    for model, batch in ((tmodels.Logistic(dim=1, alpha=1.0), (X, torch.tensor([1.0, 0.0]))),
                         (tmodels.Poisson(dim=1, alpha=1.0),
                          (X / 10.0, torch.tensor([3.0, 0.0])))):
        v, g = lift_value_and_grad(model.make_logdensity(batch))(start)
        assert bool(torch.isfinite(v).all()) and bool(torch.isfinite(g["weights"]).all())


def test_predict_matches_jax():
    jm, tm, params, (X, _) = _case("logistic")
    np.testing.assert_allclose(tm.predict(_t(params), torch.from_numpy(X), prob=True).numpy(),
                               np.asarray(jm.predict(params, X, prob=True)), rtol=RTOL)
    np.testing.assert_array_equal(tm.predict(_t(params), torch.from_numpy(X)).numpy(),
                                  np.asarray(jm.predict(params, X)))
    jm, tm, params, (X, _) = _case("poisson")
    np.testing.assert_allclose(tm.predict(_t(params), torch.from_numpy(X)).numpy(),
                               np.asarray(jm.predict(params, X)), rtol=RTOL)


def test_init_params_shapes_and_generator():
    g = torch.Generator().manual_seed(0)
    p = tmodels.Logistic(dim=4).init_params(g, "cpu")
    assert p["weights"].shape == (4,) and p["bias"].shape == ()
    assert float(p["weights"].abs().max()) < 0.1 and float(p["bias"]) == 0.0
    q = tmodels.Logistic(dim=4).init_params(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["weights"], q["weights"])
    assert tmodels.MVNGaussian(np.zeros(2, np.float32), np.eye(2, dtype=np.float32)) \
        .init_params(g, "cpu")["x"].shape == (2,)
    assert tmodels.Gaussian(dim=3).init_params(g, "cpu")["x"].shape == (3,)


@pytest.mark.parametrize("name", CASES)
def test_check_gradient(name):
    """The finite-difference checker passes on the autograd and on the
    analytic gradient, and raises on a wrong one."""
    _, tm, params, batch = _case(name)
    fn = tm.make_logdensity(_tb(batch))
    tparams = _t(params)
    assert tutils.check_gradient(fn, tparams, rtol=5e-2, atol=5e-2)
    assert tutils.check_gradient(fn, tparams, tm.analytic_grad(tparams, _tb(batch)),
                                 rtol=5e-2, atol=5e-2)
    wrong = {k: v + 1.0 for k, v in tm.analytic_grad(tparams, _tb(batch)).items()}
    with pytest.raises(AssertionError, match="gradient mismatch"):
        tutils.check_gradient(fn, tparams, wrong, rtol=5e-2, atol=5e-2)


def test_preprocessing_matches_jax():
    rng = np.random.RandomState(2)
    y = rng.randint(0, 5, size=20)
    np.testing.assert_array_equal(tutils.one_hot(y, 5).numpy(), np.asarray(jutils.one_hot(y, 5)))
    X = rng.randn(30, 4).astype(np.float32)
    X[:, 2] = 3.0        # a constant feature: scale 1, not 0
    got = tutils.MinMaxScaler().fit_transform(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(jutils.MinMaxScaler().fit_transform(X)),
                               rtol=1e-6)
    nested = [1, [2, (3, [4, "ab"])], 5]
    assert tutils.flatten(nested) == jutils.flatten(nested) == [1, 2, 3, 4, "ab", 5]
