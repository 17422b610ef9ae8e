"""The port's metrics against the JAX package's, and the explicit
transposes of the whitening maps.

PyTorch has no ``jax.linear_transpose``, so the per-chain NUTS carries
gradients between parameter and whitened space through hand-written
transposes.  They are held to the adjoint identity <A a, b> = <a, A^T b>
(rtol 1e-4 on f32 sums of ~10-8000 terms) and, for the dense metric, to
``jax.linear_transpose`` itself (rtol 1e-5).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.ops import kron_metric as jkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import metrics as jmetrics  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric as tkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import metrics as tmetrics  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.tree import tree_batched_dot  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import (  # noqa: E402
    dense_metric_from_jax,
)

C = 5


def _spd(dim, seed):
    a = np.random.RandomState(seed).randn(dim, dim)
    return (a @ a.T + 0.5 * np.eye(dim)).astype(np.float32)


def _rand_like(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(C, *s).astype(np.float32)) for k, s in shapes.items()}


def _kron(seed):
    rng = np.random.RandomState(seed)
    d, k = 12, 4
    X = rng.rand(50, d).astype(np.float32)
    gram = tkm.gram_eigh_augmented(torch.from_numpy(X))
    return tkm.KronMetric(gram, tkm.class_fisher_eigh(k), 0.7, "cpu"), {"weights": (d, k),
                                                                         "bias": (k,)}


def _dense(seed):
    shapes = {"b": (2,), "w": (3, 2)}
    like = {k: torch.zeros(C, *s) for k, s in shapes.items()}
    return tmetrics.dense_metric(_spd(8, seed), like), shapes


@pytest.mark.parametrize("make", [_dense, _kron], ids=["dense", "kron"])
def test_whitening_transposes_satisfy_the_adjoint_identity(make):
    metric, shapes = make(0)
    a, b = _rand_like(shapes, 1), _rand_like(shapes, 2)
    for fwd, adj in ((metric.whiten, metric.whiten_transpose),
                     (metric.unwhiten, metric.unwhiten_transpose)):
        np.testing.assert_allclose(tree_batched_dot(fwd(a), b).numpy(),
                                   tree_batched_dot(a, adj(b)).numpy(), rtol=1e-4, atol=1e-4)
    # and the maps invert each other
    back = metric.unwhiten(metric.whiten(a))
    for k in a:
        np.testing.assert_allclose(back[k].numpy(), a[k].numpy(), rtol=1e-3, atol=1e-4)


def test_dense_metric_matches_jax_and_linear_transpose():
    """Every map of the dense metric, per chain, against the JAX metric built
    from the same matrix (the port takes JAX's eigendecomposition, so the
    whitened coordinates have the same signs)."""
    M = _spd(8, 3)
    one = {"b": jnp.zeros(2), "w": jnp.zeros((3, 2))}
    jm = jmetrics.dense_metric(jnp.asarray(M), one)
    shapes = {"b": (2,), "w": (3, 2)}
    tm = dense_metric_from_jax(*jnp.linalg.eigh(jnp.asarray(M)),
                               {k: torch.zeros(C, *s) for k, s in shapes.items()})
    a = _rand_like(shapes, 4)
    ja = {k: jnp.asarray(v.numpy()) for k, v in a.items()}
    whiten_t = jax.linear_transpose(jm.whiten, one)
    unwhiten_t = jax.linear_transpose(jm.unwhiten, one)
    pairs = [(tm.whiten, jm.whiten), (tm.unwhiten, jm.unwhiten),
             (tm.kinetic_grad, jm.kinetic_grad),
             (tm.whiten_transpose, lambda t: whiten_t(t)[0]),
             (tm.unwhiten_transpose, lambda t: unwhiten_t(t)[0])]
    for tfn, jfn in pairs:
        got, ref = tfn(a), jax.vmap(jfn)(ja)
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.kinetic_energy(a).numpy(),
                               np.asarray(jax.vmap(jm.kinetic_energy)(ja)), rtol=1e-5)
    # sample_position with JAX's own normal draw injected
    keys = jax.random.split(jax.random.key(0), C)
    eps = jax.vmap(lambda k: jax.random.normal(k, (8,)))(keys)
    ref = jax.vmap(jm.sample_position)(keys, ja)
    got = tm.sample_position(a, torch.from_numpy(np.array(eps)))
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5)


def test_dense_metric_own_eigh_and_momentum_law():
    """The port's own (float64, host) eigendecomposition: K(p) = p^T M^-1 p / 2,
    and momenta drawn from a generator have covariance M."""
    M = _spd(4, 5)
    like = {"x": torch.zeros(4000, 4)}
    metric = tmetrics.dense_metric(M, like)
    p = metric.sample_momentum(like, torch.Generator().manual_seed(0))["x"]
    np.testing.assert_allclose(np.cov(p.numpy().T), M, atol=0.15 * float(np.abs(M).max()))
    ref = 0.5 * np.einsum("ci,ij,cj->c", p.numpy(), np.linalg.inv(M.astype(np.float64)),
                          p.numpy())
    np.testing.assert_allclose(metric.kinetic_energy({"x": p}).numpy(), ref, rtol=1e-4)
    with pytest.raises(ValueError, match="Generator"):
        metric.sample_momentum(like, None)


def test_diagonal_and_unit_metric_match_jax():
    shapes = {"b": (2,), "w": (3, 2)}
    rng = np.random.RandomState(6)
    inv_mass = {k: torch.from_numpy(rng.uniform(0.2, 3.0, (C, *s)).astype(np.float32))
                for k, s in shapes.items()}
    p = _rand_like(shapes, 7)
    tm = tmetrics.diagonal_metric(inv_mass)
    assert tmetrics.batched_diagonal_metric is tmetrics.diagonal_metric
    for c in range(C):
        jm = jmetrics.diagonal_metric({k: jnp.asarray(v[c].numpy()) for k, v in inv_mass.items()})
        jp = {k: jnp.asarray(v[c].numpy()) for k, v in p.items()}
        np.testing.assert_allclose(float(tm.kinetic_energy(p)[c]), float(jm.kinetic_energy(jp)),
                                   rtol=1e-5)
        for k in shapes:
            np.testing.assert_allclose(tm.kinetic_grad(p)[k][c].numpy(),
                                       np.asarray(jm.kinetic_grad(jp)[k]), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.unit_metric(p).kinetic_energy(p).numpy(),
                               0.5 * tree_batched_dot(p, p).numpy(), rtol=1e-6)


def test_logistic_gauss_newton_metric_matches_jax():
    rng = np.random.RandomState(8)
    X = rng.randn(300, 6).astype(np.float32)
    jm = jkm.logistic_gauss_newton_metric(jnp.asarray(X), alpha=0.3, likelihood_scale=2.0)
    tm = tkm.logistic_gauss_newton_metric(torch.from_numpy(X), alpha=0.3, likelihood_scale=2.0)
    p = {"weights": torch.from_numpy(rng.randn(C, 6).astype(np.float32)),
         "bias": torch.from_numpy(rng.randn(C).astype(np.float32))}
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    # the eigenvectors' signs are free, but K and M^-1 p do not depend on them
    np.testing.assert_allclose(tm.kinetic_energy(p).numpy(),
                               np.asarray(jax.vmap(jm.kinetic_energy)(jp)), rtol=1e-4)
    ref = jax.vmap(jm.kinetic_grad)(jp)
    for k in p:
        np.testing.assert_allclose(tm.kinetic_grad(p)[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-6)
    big = {"weights": torch.zeros(4000, 6), "bias": torch.zeros(4000)}
    mom = tm.sample_momentum(big, torch.Generator().manual_seed(1))
    M_w = 2.0 * 0.25 * X.T.astype(np.float64) @ X + 0.3 * np.eye(6)
    np.testing.assert_allclose(np.cov(mom["weights"].numpy().T), M_w,
                               atol=0.15 * float(np.abs(M_w).max()))
    np.testing.assert_allclose(float(mom["bias"].var()), 2.0 * 0.25 * 300 + 0.3, rtol=0.15)


def test_kron_metric_momentum_law():
    """p ~ N(0, M): whitened by M^{-1/2} the momenta are standard normal, so
    2 K(p) / dim averages to 1."""
    metric, shapes = _kron(9)
    like = {k: torch.zeros(400, *s) for k, s in shapes.items()}
    p = metric.sample_momentum(like, torch.Generator().manual_seed(2))
    dim = 13 * 4
    assert abs(float(2.0 * metric.kinetic_energy(p).mean()) / dim - 1.0) < 0.05
