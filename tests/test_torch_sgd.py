"""Parity of the port's momentum SGD (with the input-feature dropout of
``fit_dropout``) with the JAX package, on the CPU in f32.

The JAX step's one random number, ``bernoulli(key, 1 - dropout_rate,
X.shape)``, is replayed into the port's ``SGDDraws``; ``fit`` is replayed
with the JAX loop's key splits (``split(key, num_steps)``, each split into
(batch, step) keys).  Positions, momenta and losses agree within rtol 1e-5
(atol 1e-6: summation order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import sgd as jsgd  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import DropoutMLP as JaxMLP  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgd  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
D, H, K, B, N = 10, 16, 3, 32, 300


@pytest.fixture(autouse=True)
def one_thread():
    """Loops of thousands of tiny ops: one intra-op thread is as fast alone
    and does not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem():
    rng = np.random.RandomState(0)
    X = rng.randn(N, D).astype(np.float32)
    yi = (X @ rng.randn(D, K)).argmax(-1)
    shapes = {"W1": (D, H), "b1": (H,), "W2": (H, H), "b2": (H,), "W3": (H, K), "b3": (K,)}
    params = {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
    return (JaxMLP(D, H, K, alpha=0.1), DropoutMLP(D, H, K, alpha=0.1), X,
            np.eye(K, dtype=np.float32)[yi], yi, params)


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}[{k}]")


@pytest.mark.parametrize("dropout_rate", [0.0, 0.3], ids=["plain", "input-mask"])
def test_sgd_step_matches_jax(dropout_rate):
    jm, tm, X, y, _, params = _problem()
    jkernel = jsgd.build_sgd_kernel(jm.make_batched_logdensity(N), gamma=0.8,
                                    dropout_rate=dropout_rate)
    tkernel = sgd.build_sgd_kernel(tm.make_batched_logdensity(N), gamma=0.8,
                                   dropout_rate=dropout_rate)
    jstate = jsgd.sgd_init(params)
    tstate = sgd.sgd_init(params_from_jax(params, "cpu", add_chain_axis=True))
    Xb, yb = X[:B], y[:B]
    batch = (torch.from_numpy(Xb)[None], torch.from_numpy(yb)[None])
    for i in range(3):     # the momentum carries over
        key = jax.random.key(7 + i)
        mask = np.array(jax.random.bernoulli(key, 1.0 - dropout_rate, Xb.shape))
        jstate, jloss = jkernel(key, jstate, (jnp.asarray(Xb), jnp.asarray(yb)), 1e-4)
        tstate, tloss = tkernel(tstate, batch, 1e-4,
                                draws=sgd.SGDDraws(mask=torch.from_numpy(mask)[None]))
        _close(tstate.position, jstate.position, "position")
        _close(tstate.momentum, jstate.momentum, "momentum")
        np.testing.assert_allclose(tloss.numpy(), [float(jloss)], rtol=RTOL)
    if dropout_rate:      # the mask is on the inputs, without a rescale
        unmasked = sgd.build_sgd_kernel(tm.make_batched_logdensity(N), gamma=0.8)
        _, plain_loss = unmasked(tstate, batch, 1e-4)
        _, masked_loss = tkernel(tstate, batch, 1e-4,
                                 draws=sgd.SGDDraws(mask=torch.ones_like(batch[0]).bool()))
        np.testing.assert_allclose(masked_loss.numpy(), plain_loss.numpy(), rtol=1e-6)
    converted = params_from_jax(jstate, "cpu", add_chain_axis=True)
    assert isinstance(converted, sgd.SGDState) and converted.momentum["W2"].shape == (1, H, H)


def test_fit_replays_the_jax_run_and_learns():
    jm, tm, X, y, yi, params = _problem()
    steps, key = 6, jax.random.key(1)
    jstate, jlosses = jsgd.fit(
        jsgd.build_sgd_kernel(jm.make_batched_logdensity(N), dropout_rate=0.2),
        jsgd.sgd_init(params), key, (jnp.asarray(X), jnp.asarray(y)), batch_size=B,
        num_steps=steps, step_size=2e-4)

    def replayed():
        for k in jax.random.split(key, steps):
            k_batch, k_step = jax.random.split(k)
            idx = np.array(jax.random.randint(k_batch, (B,), 0, N))
            mask = np.array(jax.random.bernoulli(k_step, 0.8, (B, D)))
            yield sgd.SGDDraws(torch.from_numpy(idx).long()[None], torch.from_numpy(mask)[None])

    data = (torch.from_numpy(X), torch.from_numpy(y))
    tkernel = sgd.build_sgd_kernel(tm.make_batched_logdensity(N), dropout_rate=0.2)
    start = sgd.sgd_init(params_from_jax(params, "cpu", add_chain_axis=True))
    tstate, tlosses = sgd.fit(tkernel, start, data, B, steps, 2e-4, draws=replayed())
    assert tlosses.shape == (1, steps)
    np.testing.assert_allclose(tlosses[0].numpy(), np.asarray(jlosses), rtol=RTOL)
    _close(tstate.position, jstate.position, "position")

    # from its own generator: two chains at once, both learn the labels
    two = sgd.sgd_init({k: v.repeat((2,) + (1,) * (v.dim() - 1))
                        for k, v in start.position.items()})
    fitted, losses = sgd.fit(tkernel, two, data, 64, 400, 2e-4,
                             generator=torch.Generator().manual_seed(0))
    assert losses.shape == (2, 400)
    assert float(losses[:, -50:].mean()) < 0.7 * float(losses[:, :50].mean())
    assert not torch.equal(fitted.position["W1"][0], fitted.position["W1"][1])
    for c in range(2):
        pred = tm.predict({k: v[c] for k, v in fitted.position.items()}, data[0]).numpy()
        assert (pred == yi).mean() > 0.8
