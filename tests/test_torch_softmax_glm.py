"""Parity of the port's fused softmax-GLM value+grad with the JAX package.

On the CPU the port's wrapper runs the plain PyTorch version (the CUDA kernel
is tested on the card in test_torch_softmax_glm_gpu.py).  The same numpy
inputs go through:
  - jax.vmap(jax.value_and_grad(Softmax.make_logdensity)) at 'highest'
    precision: value rtol 1e-6, grads atol 1e-4 * max|g| (both f32, only
    the summation order differs);
  - the Pallas kernel in interpret mode (ops/pallas_glm.py), whose backward
    is single-pass bf16: the tolerances of tests/test_pallas.py (value rtol
    3e-4, grads rtol 2e-2 with atol 3.9e-3 * max|g|).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.pallas_glm import (  # noqa: E402
    softmax_value_and_grad as jax_fused,
)
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg  # noqa: E402

D, K, C = 32, 7, 5
ALPHA = 0.7


def _data(seed, n, grid=True):
    rng = np.random.RandomState(seed)
    if grid:   # the 8-bit grid k/256 of the headline data (exact in bf16)
        X = (rng.randint(0, 256, size=(n, D)) / 256.0).astype(np.float32)
    else:
        X = rng.randn(n, D).astype(np.float32)
    Y = np.eye(K, dtype=np.float32)[rng.randint(0, K, size=n)]
    W = (0.3 * rng.randn(C, D, K)).astype(np.float32)
    b = (0.1 * rng.randn(C, K)).astype(np.float32)
    return X, Y, W, b


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,grid", [(300, False), (257, True)])
def test_plain_matches_jax_autodiff(n, grid):
    X, Y, W, b = _data(0, n, grid)
    ld = JaxSoftmax(dim=D, n_classes=K, alpha=ALPHA).make_logdensity(batch=(X, Y))
    with jax.default_matmul_precision("highest"):
        ref_v, ref_g = jax.vmap(jax.value_and_grad(ld))(
            {"weights": jnp.asarray(W), "bias": jnp.asarray(b)})
    v, gw, gb = sg.softmax_value_and_grad(*_torch(X, Y, W, b), ALPHA)

    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=1e-6)
    for got, ref in ((gw, ref_g["weights"]), (gb, ref_g["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("fwd_full", [True, False])
def test_plain_matches_pallas_interpret(fwd_full):
    """Ragged N (300 rows over 128-row tiles), X on the 8-bit grid."""
    X, Y, W, b = _data(1, 300)
    ref_v, ref_gw, ref_gb = jax_fused(X, Y, W, b, ALPHA, tile_rows=128,
                                      interpret=True, fwd_full=fwd_full)
    tX, tY, tW, tb = _torch(X, Y, W, b)
    ll, _, _ = sg.softmax_value_and_grad_plain(tX, tY, tW, tb)
    v = ll + sg.log_prior_batched(tW, tb, ALPHA)
    value, gw, gb = sg.softmax_value_and_grad(tX, tY, tW, tb, ALPHA,
                                              fwd_full=fwd_full)
    assert (value is None) == (not fwd_full)

    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=3e-4)
    for got, ref in ((gw, ref_gw), (gb, ref_gb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2,
                                   atol=3.9e-3 * np.abs(ref).max())


def test_include_prior_false_row_shards_compose():
    """Likelihood-only outputs of two row shards, summed, plus the prior
    once, equal the full call."""
    tX, tY, tW, tb = _torch(*_data(2, 300, grid=False))
    v_full, gw_full, gb_full = sg.softmax_value_and_grad(tX, tY, tW, tb, ALPHA)
    parts = [sg.softmax_value_and_grad(tX[i:j].contiguous(), tY[i:j].contiguous(),
                                       tW, tb, ALPHA, include_prior=False)
             for i, j in ((0, 150), (150, 300))]
    v = parts[0][0] + parts[1][0] + sg.log_prior_batched(tW, tb, ALPHA)
    gw = parts[0][1] + parts[1][1] - ALPHA * tW
    gb = parts[0][2] + parts[1][2] - ALPHA * tb
    np.testing.assert_allclose(v.numpy(), v_full.numpy(), rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(gw.numpy(), gw_full.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), gb_full.numpy(), rtol=1e-4, atol=1e-4)


def test_model_matches_jax_model():
    """Single-chain log_prior / log_likelihood / predict / analytic_grad and
    the chain-batched fused maker, against the JAX Softmax."""
    X, Y, W, b = _data(3, 200, grid=False)
    jm = JaxSoftmax(dim=D, n_classes=K, alpha=ALPHA)
    tm = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    jp = {"weights": jnp.asarray(W[0]), "bias": jnp.asarray(b[0])}
    tp = {"weights": torch.from_numpy(W[0]), "bias": torch.from_numpy(b[0])}
    tX, tY = _torch(X, Y)
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(float(tm.log_prior(tp)), float(jm.log_prior(jp)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm.log_posterior(tp, (tX, tY))),
                                   float(jm.log_posterior(jp, (X, Y))), rtol=1e-6)
        np.testing.assert_array_equal(tm.predict(tp, tX).numpy(),
                                      np.asarray(jm.predict(jp, X)))
        ref = jm.analytic_grad(jp, (X, Y))
    got = tm.analytic_grad(tp, (tX, tY))
    for key in ("weights", "bias"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r, atol=1e-4 * np.abs(r).max())

    value, grads = tm.make_fused_value_and_grad((tX, tY))(
        {"weights": torch.from_numpy(W), "bias": torch.from_numpy(b)})
    per_chain = [float(tm.log_posterior({"weights": torch.from_numpy(W[c]),
                                         "bias": torch.from_numpy(b[c])}, (tX, tY)))
                 for c in range(C)]
    np.testing.assert_allclose(value.numpy(), per_chain, rtol=1e-6)
    only = tm.make_fused_value_and_grad((tX, tY), fwd_full=False)(
        {"weights": torch.from_numpy(W), "bias": torch.from_numpy(b)})
    np.testing.assert_array_equal(only["weights"].numpy(), grads["weights"].numpy())
