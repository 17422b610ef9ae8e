"""Parity of the port's dual averaging and warmup loop with JAX.

Fed the same acceptance sequence, the per-chain dual-averaging states agree
to rtol 1e-6 (the same f32 arithmetic in the same order).
"""

from typing import Any, NamedTuple

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference.warmup import (  # noqa: E402
    run_warmup as jax_run_warmup,
)
from dropout_hamiltonian_montecarlo_tpu.ops import adaptation as jad  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.warmup import run_warmup  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import adaptation as tad  # noqa: E402

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_warmup(lambda *a, **k: None, _State({"x": torch.zeros(C)}, 0), 3,
                   initial_step_size=torch.full((C,), 0.1))
