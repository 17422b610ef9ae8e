"""Parity of the port's mean-field ADVI with the JAX package, on the CPU in
f32.

One step with replayed randomness: the JAX kernel draws its reparameterised
noise as ``tree_randn_like(k, mu)`` for each ``k`` of ``split(key,
num_mc_samples)``; the same numbers go into the port as ``epsilons`` (leaves
(num_mc_samples, ...)).  Loss, mu, rho and the four Adam moments agree
within rtol 1e-5 (atol 1e-6) over three steps.  The statistical tests are the
JAX package's own (tests/test_vi.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import vi as jvi  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import DropoutMLP as JaxMLP  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.tree import (  # noqa: E402
    tree_randn_like as jax_randn_like,
)
from dropout_hamiltonian_montecarlo_tpu_torch.inference import vi  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP, Softmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
D, H, K, B, N, S = 10, 16, 3, 48, 300, 3


@pytest.fixture(autouse=True)
def one_thread():
    """Loops of thousands of tiny ops: one intra-op thread is as fast alone
    and does not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name):
    rng = np.random.RandomState(0)
    X = rng.randn(B, D).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[(X @ rng.randn(D, K)).argmax(-1)]
    if name == "mlp":
        shapes = {"W1": (D, H), "b1": (H,), "W2": (H, H), "b2": (H,), "W3": (H, K), "b3": (K,)}
        models = JaxMLP(D, H, K, alpha=0.5, p_drop=0.0), DropoutMLP(D, H, K, alpha=0.5,
                                                                    p_drop=0.0)
    else:
        shapes = {"weights": (D, K), "bias": (K,)}
        models = JaxSoftmax(D, K, alpha=0.5), Softmax(D, K, alpha=0.5)
    params = {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
    return models, params, X, y


@pytest.mark.parametrize("name", ["softmax", "mlp"])
def test_vi_step_matches_jax(name):
    (jm, tm), params, X, y = _case(name)
    kw = dict(num_mc_samples=S, learning_rate=3e-2)
    jkernel = jvi.build_kernel(jm.make_batched_logdensity(N), **kw)
    tkernel = vi.build_kernel(tm.make_batched_logdensity(N), **kw)
    jstate = jvi.init(params, initial_log_std=-2.0)
    tstate = vi.init(params_from_jax(params, "cpu"), initial_log_std=-2.0)
    batch = (torch.from_numpy(X), torch.from_numpy(y))
    for i in range(3):      # Adam's bias correction moves with t
        key = jax.random.key(4 + i)
        eps = [jax_randn_like(k, jstate.mu) for k in jax.random.split(key, S)]
        epsilons = {k: torch.from_numpy(np.stack([np.array(e[k]) for e in eps])) for k in params}
        jstate, jloss = jkernel(key, jstate, (jnp.asarray(X), jnp.asarray(y)))
        tstate, tloss = tkernel(tstate, batch, epsilons=epsilons)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
        assert float(tstate.step) == float(jstate.step) == i + 1
        for field in ("mu", "rho", "opt_mu", "opt_rho", "opt2_mu", "opt2_rho"):
            got, want = getattr(tstate, field), getattr(jstate, field)
            for k in params:
                scale = float(np.abs(np.asarray(want[k])).max())
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL,
                                           atol=ATOL * max(scale, 1.0),
                                           err_msg=f"step {i} {field}[{k}]")
    converted = params_from_jax(jstate, "cpu")
    assert isinstance(converted, vi.MeanFieldState) and converted.step.shape == ()
    np.testing.assert_allclose(converted.rho[k].numpy(), tstate.rho[k].numpy(), rtol=1e-4)


def test_entropy_and_sample_from():
    rho = {"w": np.full((3, 2), -1.5, np.float32), "b": np.full((2,), 0.25, np.float32)}
    want = float(jvi._gaussian_entropy({k: jnp.asarray(v) for k, v in rho.items()}))
    got = float(vi._gaussian_entropy(params_from_jax(rho, "cpu")))
    assert got == pytest.approx(want, rel=1e-6)

    state = vi.init({"w": torch.zeros(3, 2), "b": torch.ones(2)}, initial_log_std=-1.0)
    g = torch.Generator().manual_seed(0)
    draws = vi.sample_from(state, 10, generator=g)
    assert draws["w"].shape == (10, 3, 2) and draws["b"].shape == (10, 2)
    eps = {"w": torch.ones(4, 3, 2), "b": -torch.ones(4, 2)}
    fixed = vi.sample_from(state, 4, epsilons=eps)
    np.testing.assert_allclose(fixed["b"].numpy(), 1.0 - np.exp(-1.0), rtol=1e-6)
    big = vi.sample_from(state, 4000, generator=g)["b"]
    assert abs(float(big.mean()) - 1.0) < 0.03 and abs(float(big.std()) - np.exp(-1.0)) < 0.03
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        vi.sample_from(state, 3)


def test_advi_conjugate_gaussian():
    """ADVI recovers the conjugate-Gaussian posterior (one chain's log
    density, not marked chain-batched: the MC draws go through vmap)."""
    n = 256
    gen = torch.Generator().manual_seed(0)
    y = 2.0 + torch.randn((n,), generator=gen)
    post_mean = n * float(y.mean()) / (n + 1)
    post_std = np.sqrt(1.0 / (n + 1))

    def logdensity(params, batch):
        (yb,) = batch
        return -0.5 * ((yb - params["mu"]) ** 2).sum() * (n / yb.shape[0]) \
            - 0.5 * params["mu"] ** 2

    state = vi.init({"mu": torch.zeros(())})
    kernel = vi.build_kernel(logdensity, num_mc_samples=4, learning_rate=5e-2)
    losses = []
    for _ in range(2000):
        idx = torch.randint(0, n, (64,), generator=gen)
        state, loss = kernel(state, (y[idx],), generator=gen)
        losses.append(loss)
    losses = torch.stack(losses)
    q_mean, q_std = float(state.mu["mu"]), float(torch.exp(state.rho["mu"]))
    assert abs(q_mean - post_mean) < 0.1, (q_mean, post_mean)
    assert 0.3 * post_std < q_std < 3.0 * post_std, (q_std, post_std)
    assert float(losses[-200:].mean()) < float(losses[:200].mean())
