"""Parity of the port's R-hat, calibration and summary with the JAX package,
on numpy inputs made from a seed.  Both sides are f32; tolerance 1e-5."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu import diagnostics as jdiag  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.diagnostics import rhat as jrhat  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import diagnostics as tdiag  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _draws(seed, chains=4, draws=200, shape=(3, 5)):
    """AR(1) draws with chain offsets (so R-hat departs from 1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(chains, draws, *shape)
    for t in range(1, draws):
        x[:, t] += 0.6 * x[:, t - 1]
    x += 0.3 * rng.randn(chains, 1, *shape)
    return x.astype(np.float32)


def _probs(seed, n=500, k=10):
    rng = np.random.RandomState(seed)
    logits = 2.0 * rng.randn(n, k)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    return p.astype(np.float32), rng.randint(0, k, size=n).astype(np.int32)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64), **TOL)


@pytest.mark.parametrize("fn", ["potential_scale_reduction", "split_rhat"])
def test_rhat_matches_jax(fn):
    x = _draws(0, draws=201)          # odd length: split_rhat drops the middle draw
    _close(getattr(tdiag, fn)(torch.from_numpy(x)).numpy(), getattr(jrhat, fn)(x))


def test_split_rhat_pytree_matches_jax():
    x = {"a": _draws(1), "b": _draws(2, shape=(4,))}
    got = tdiag.split_rhat_pytree({k: torch.from_numpy(v) for k, v in x.items()})
    ref = jrhat.split_rhat_pytree(x)
    for k in x:
        _close(got[k].numpy(), ref[k])


@pytest.mark.parametrize("num_bins", [10, 15])
def test_calibration_matches_jax(num_bins):
    p, y = _probs(3)
    tp, ty = torch.from_numpy(p), torch.from_numpy(y)
    for got, ref in zip(tdiag.reliability_bins(tp, ty, num_bins),
                        jdiag.reliability_bins(jnp.asarray(p), jnp.asarray(y), num_bins)):
        _close(got.numpy(), ref)
    _close(tdiag.expected_calibration_error(tp, ty, num_bins).numpy(),
           jdiag.expected_calibration_error(p, y, num_bins))
    _close(tdiag.predictive_nll(tp, ty).numpy(), jdiag.predictive_nll(p, y))
    got, ref = tdiag.calibration_report(tp, ty, num_bins), jdiag.calibration_report(p, y, num_bins)
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k])


def test_posterior_predictive_probs_matches_jax():
    rng = np.random.RandomState(4)
    draws = {"weights": rng.randn(3, 50, 6, 4).astype(np.float32),
             "bias": rng.randn(3, 50, 4).astype(np.float32)}
    X = rng.randn(40, 6).astype(np.float32)

    def jpredict(p, x):
        return jax.nn.softmax(x @ p["weights"] + p["bias"], axis=-1)

    def tpredict(p, x):
        return torch.softmax(x @ p["weights"] + p["bias"], dim=-1)

    for max_draws in (32, 500):      # thinned, and all 150 draws
        ref = jdiag.posterior_predictive_probs(jpredict, draws, X, max_draws=max_draws)
        got = tdiag.posterior_predictive_probs(
            tpredict, {k: torch.from_numpy(v) for k, v in draws.items()}, torch.from_numpy(X),
            max_draws=max_draws)
        _close(got.numpy(), ref)


@pytest.mark.parametrize("elapsed", [None, 2.5])
def test_summarize_matches_jax(elapsed):
    x = {"w": _draws(5), "b": _draws(6, draws=200, shape=(4,))}
    ref = jdiag.summarize(x, elapsed_seconds=elapsed)
    got = tdiag.summarize({k: torch.from_numpy(v) for k, v in x.items()},
                          elapsed_seconds=elapsed)
    assert got.keys() == ref.keys()
    for name in ("w", "b"):
        for stat in ("mean", "std", "ess", "rhat"):
            _close(got[name][stat].numpy(), ref[name][stat])
    assert got["aggregate"].keys() == ref["aggregate"].keys()
    for k, v in ref["aggregate"].items():
        np.testing.assert_allclose(float(got["aggregate"][k]), float(v), rtol=1e-5)


def test_summarize_bare_tensor_and_even_median():
    x = _draws(7, shape=(4,))        # 4 coordinates: the median averages the middle two
    got = tdiag.summarize(torch.from_numpy(x))
    ref = jdiag.summarize(x)
    assert set(got) == set(ref) == {"", "aggregate"}
    ess = got[""]["ess"].numpy()
    np.testing.assert_allclose(float(got["aggregate"]["median_ess"]),
                               np.sort(ess)[1:3].mean(), rtol=1e-6)
    np.testing.assert_allclose(float(got["aggregate"]["median_ess"]),
                               float(ref["aggregate"]["median_ess"]), rtol=1e-5)
