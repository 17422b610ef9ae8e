"""Parity of the port's dropout MLP (and of both models' stochastic
predictions) with the JAX package.

The same numpy inputs go through both packages on the CPU in f32.  JAX's
dropout masks are replayed: ``jax.random.split(key, 3)`` then ``bernoulli``,
as ``DropoutMLP.logits`` draws them, handed to the port as ``DropoutMasks``.
Logits, log posterior and its gradient agree within rtol 1e-5 (atol 1e-5 for
entries near zero: the two differ only in summation order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu import models as jmodels  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import models as tmodels  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.sgmcmc import _make_vag  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
D, H, K, B, C, N = 12, 16, 4, 40, 3, 400
ALPHA, P_DROP = 0.3, 0.2


@pytest.fixture(autouse=True)
def one_thread():
    """Loops of thousands of tiny ops: one intra-op thread is as fast alone
    and does not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models():
    return (jmodels.DropoutMLP(D, H, K, alpha=ALPHA, p_drop=P_DROP),
            tmodels.DropoutMLP(D, H, K, alpha=ALPHA, p_drop=P_DROP))


def _params(rng, chains=None):
    lead = () if chains is None else (chains,)
    shapes = {"W1": (D, H), "b1": (H,), "W2": (H, H), "b2": (H,), "W3": (H, K), "b3": (K,)}
    return {k: (0.4 * rng.randn(*(lead + s))).astype(np.float32) for k, s in shapes.items()}


def _batch(rng, chains=None):
    lead = () if chains is None else (chains,)
    X = rng.randn(*(lead + (B, D))).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[rng.randint(0, K, size=lead + (B,))]
    return X, y


def jax_masks(key, shape, keep=1.0 - P_DROP):
    """The three masks ``DropoutMLP.logits`` draws from ``key``, as numpy."""
    return tuple(np.asarray(jax.random.bernoulli(k, keep, shape))
                 for k in jax.random.split(key, 3))


def _t(tree):
    return params_from_jax(tree, "cpu")


def _masks(arrays):
    return tmodels.DropoutMasks(*(torch.from_numpy(np.array(a)) for a in arrays))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_logits_match(masked):
    rng = np.random.RandomState(0)
    jm, tm = _models()
    params, (X, _) = _params(rng), _batch(rng)
    key = jax.random.key(5) if masked else None
    want = np.asarray(jm.logits(params, jnp.asarray(X), key))
    masks = _masks(jax_masks(key, (B, H))) if masked else None
    got = tm.logits(_t(params), torch.from_numpy(X), masks)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if masked:     # the masks do something: about p_drop of the units are off
        plain = tm.logits(_t(params), torch.from_numpy(X))
        assert not np.allclose(plain.numpy(), want, atol=1e-3)
        assert 0.1 < 1.0 - masks.first.float().mean() < 0.3


@pytest.mark.parametrize("per_chain_batch", [False, True], ids=["shared", "per-chain"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_log_posterior_and_gradient_match_vmapped_jax(masked, per_chain_batch):
    rng = np.random.RandomState(1)
    jm, tm = _models()
    params = _params(rng, C)
    X, y = _batch(rng, C if per_chain_batch else None)
    keys = jax.random.split(jax.random.key(9), C)

    def one(p, xb, yb, k):
        return jax.value_and_grad(
            lambda q: jm.log_posterior(q, (xb, yb), N, k if masked else None))(p)

    axes = (0, 0, 0, 0) if per_chain_batch else (0, None, None, 0)
    want_v, want_g = jax.vmap(one, in_axes=axes)(params, jnp.asarray(X), jnp.asarray(y), keys)

    masks = None
    if masked:
        per = [jax_masks(k, (B, H)) for k in keys]
        masks = _masks([np.stack([m[i] for m in per]) for i in range(3)])
    ld = tm.make_batched_logdensity(N, dropout=masked)
    vag, value_fn = _make_vag(ld, masked, None)
    batch = (torch.from_numpy(X), torch.from_numpy(y))
    got_v, got_g = vag(_t(params), batch, masks)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL)
    np.testing.assert_allclose(value_fn(_t(params), batch, masks).numpy(), got_v.numpy(),
                               rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]), rtol=RTOL,
                                   atol=ATOL * float(np.abs(want_g[k]).max()), err_msg=k)


def test_shared_and_per_chain_batches_agree_and_scale_by_n_over_b():
    """One batch handed over as (B, D) or tiled to (C, B, D) gives the same
    densities, and the likelihood is scaled by N / B in both forms (not by
    N / C: the batch size is read off the row axis)."""
    rng = np.random.RandomState(2)
    _, tm = _models()
    params, (X, y) = _t(_params(rng, C)), _batch(rng)
    shared = (torch.from_numpy(X), torch.from_numpy(y))
    tiled = tuple(b.expand((C,) + b.shape).contiguous() for b in shared)
    assert tm.batch_size(shared) == tm.batch_size(tiled) == B
    for batch in (shared, tiled):
        post = tm.log_posterior(params, batch, N)
        want = tm.log_prior(params) + (N / B) * tm.log_likelihood(params, batch)
        np.testing.assert_allclose(post.numpy(), want.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tm.log_posterior(params, tiled, N).numpy(),
                               tm.log_posterior(params, shared, N).numpy(), rtol=1e-5)
    # one chain's params on the shared batch: a scalar, chain 0's value
    one = {k: v[0] for k, v in params.items()}
    np.testing.assert_allclose(float(tm.log_posterior(one, shared, N)),
                               float(tm.log_posterior(params, shared, N)[0]), rtol=1e-5)


def test_softmax_per_chain_batches_scale_by_n_over_b():
    """models/base.py reads the batch size off the row axis: the softmax
    model on per-chain minibatches agrees with the JAX model under vmap."""
    rng = np.random.RandomState(3)
    params = {"weights": (0.3 * rng.randn(C, D, K)).astype(np.float32),
              "bias": (0.1 * rng.randn(C, K)).astype(np.float32)}
    X, y = _batch(rng, C)
    jm = jmodels.Softmax(D, K, alpha=ALPHA)
    tm = tmodels.Softmax(D, K, alpha=ALPHA)
    want = jax.vmap(lambda p, xb, yb: jm.log_posterior(p, (xb, yb), N))(
        params, jnp.asarray(X), jnp.asarray(y))
    got = tm.make_batched_logdensity(N)(_t(params), (torch.from_numpy(X), torch.from_numpy(y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("prob", [True, False], ids=["prob", "argmax"])
def test_predict_stochastic_of_both_models(prob):
    rng = np.random.RandomState(4)
    jm, tm = _models()
    params, (X, _) = _params(rng), _batch(rng)
    key = jax.random.key(2)
    want = np.asarray(jm.predict_stochastic(params, jnp.asarray(X), key, prob=prob))
    got = tm.predict_stochastic(_t(params), torch.from_numpy(X),
                                masks=_masks(jax_masks(key, (B, H))), prob=prob)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tm.predict(_t(params), torch.from_numpy(X), prob=prob).numpy(),
                               np.asarray(jm.predict(params, jnp.asarray(X), prob=prob)),
                               rtol=RTOL, atol=1e-6)

    # the softmax model masks the INPUT features, keep probability 1 - p_drop,
    # without a rescale
    sp = {"weights": (0.3 * rng.randn(D, K)).astype(np.float32),
          "bias": (0.1 * rng.randn(K)).astype(np.float32)}
    js, ts = jmodels.Softmax(D, K), tmodels.Softmax(D, K)
    mask = np.array(jax.random.bernoulli(key, 1.0 - 0.3, X.shape))
    want = np.asarray(js.predict_stochastic(sp, jnp.asarray(X), key, p_drop=0.3, prob=prob))
    got = ts.predict_stochastic(_t(sp), torch.from_numpy(X), mask=torch.from_numpy(mask),
                                prob=prob)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_fresh_masks_and_init_params():
    _, tm = _models()
    g = torch.Generator().manual_seed(0)
    params = tm.init_params(g, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "W1": (D, H), "b1": (H,), "W2": (H, H), "b2": (H,), "W3": (H, K), "b3": (K,)}
    assert all(float(params[b].abs().max()) == 0.0 for b in ("b1", "b2", "b3"))
    big = tmodels.DropoutMLP(200, 300, 10).init_params(g, "cpu")      # Glorot scale
    assert abs(float(big["W1"].std()) / np.sqrt(2.0 / 500) - 1.0) < 0.05

    X = torch.randn((B, D), generator=g)
    batched = {k: v.expand((C,) + v.shape) for k, v in params.items()}
    for p, xb, shape in ((params, X, (B, H)), (batched, X, (C, B, H)),
                         (batched, X.expand(C, B, D), (C, B, H))):
        masks = tm.draw_masks(p, xb, g)
        assert all(m.shape == shape and m.dtype == torch.bool for m in masks)
        assert not torch.equal(masks.first, masks.second)
    a = tm.predict_stochastic(params, X, generator=g, prob=True)
    b = tm.predict_stochastic(params, X, generator=g, prob=True)
    assert a.shape == (B, K) and not torch.equal(a, b)
    with pytest.raises(ValueError, match="masks= or an explicit generator="):
        tm.predict_stochastic(params, X)
