"""Parity of the port's FFT ESS with the JAX package, on AR(1) draws.

Both sides compute in f32 with different FFT libraries; the Geyer cut is a
discrete choice, so the draws are seeded and the tolerance is rtol 1e-4.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.diagnostics.ess import (  # noqa: E402
    effective_sample_size as jax_ess,
)
from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics.ess import (  # noqa: E402
    effective_sample_size,
)


def _ar1(chains, draws, shape, seed):
    """AR(1) draws with a coefficient per parameter in [0, 0.9]."""
    rng = np.random.RandomState(seed)
    phi = np.linspace(0.0, 0.9, int(np.prod(shape))).reshape(shape)
    x = np.zeros((chains, draws) + shape)
    noise = rng.randn(chains, draws, *shape)
    x[:, 0] = noise[:, 0]
    for t in range(1, draws):
        x[:, t] = phi * x[:, t - 1] + noise[:, t]
    return (x + rng.randn(chains, 1, *shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("block_size", [None, 0, 4])
def test_ess_matches_jax(block_size):
    """block 4 over 15 parameters exercises the blocked path and its ragged
    last block."""
    x = _ar1(4, 400, (3, 5), seed=0)
    got = effective_sample_size(torch.from_numpy(x), block_size=block_size).numpy()
    ref = np.asarray(jax_ess(x, block_size=block_size))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    # sanity: strongly autocorrelated coordinates have far lower ESS
    assert got.ravel()[-1] < 0.3 * got.ravel()[0]


def test_ess_scalar_and_single_chain():
    x = _ar1(1, 301, (2,), seed=1)
    got = effective_sample_size(torch.from_numpy(x[..., 0])).numpy()
    ref = np.asarray(jax_ess(x[..., 0]))
    assert got.shape == ()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_ess_pytree_matches_jax():
    from dropout_hamiltonian_montecarlo_tpu.diagnostics.ess import ess_pytree as jax_ess_pytree
    from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics import ess_pytree

    tree = {"weights": _ar1(3, 200, (2, 3), seed=2), "bias": _ar1(3, 200, (3,), seed=3)}
    got = ess_pytree({k: torch.from_numpy(v) for k, v in tree.items()})
    ref = jax_ess_pytree(tree)
    assert set(got) == set(ref)
    for k in tree:
        assert got[k].shape == tree[k].shape[2:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4)
    one = ess_pytree(torch.from_numpy(tree["bias"]))
    np.testing.assert_array_equal(one.numpy(), got["bias"].numpy())
