"""Parity of the port's chain-batched leapfrog and HMC kernel with JAX.

JAX's threefry streams cannot be reproduced in PyTorch, so the test draws
the momenta and accept uniforms with the same jax.random calls the JAX kernel
makes (inference/hmc.py: split(key) -> (momentum key, accept key),
tree_randn_like for the momenta, uniform for the accept) and hands them to
the port as injected draws.  Both sides are f32 on the CPU and differ only in
summation order: positions and energies rtol 1e-4, accept probabilities
rtol 1e-3, accept decisions equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import hmc as jhmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.integrators import (  # noqa: E402
    IntegratorState as JaxIntegratorState,
    velocity_verlet_batched as jax_verlet_batched,
)
from dropout_hamiltonian_montecarlo_tpu.ops.metrics import (  # noqa: E402
    batched_diagonal_metric as jax_batched_metric,
)
from dropout_hamiltonian_montecarlo_tpu.ops.tree import tree_randn_like  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.integrators import (  # noqa: E402
    IntegratorState,
    velocity_verlet_batched,
)
from dropout_hamiltonian_montecarlo_tpu_torch.ops.metrics import (  # noqa: E402
    batched_diagonal_metric,
)
from dropout_hamiltonian_montecarlo_tpu_torch.ops.tree import tree_ones_like  # noqa: E402

N, D, K, C = 300, 32, 7, 6
ALPHA = 0.7


def _problem(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D).astype(np.float32)
    Y = np.eye(K, dtype=np.float32)[rng.randint(0, K, size=N)]
    pos = {"weights": (0.03 * rng.randn(C, D, K)).astype(np.float32),
           "bias": (0.01 * rng.randn(C, K)).astype(np.float32)}
    jax_vag_raw = jax.vmap(jax.value_and_grad(
        JaxSoftmax(dim=D, n_classes=K, alpha=ALPHA).make_logdensity(batch=(X, Y))))

    def jax_vag(p):
        with jax.default_matmul_precision("highest"):
            return jax_vag_raw(p)

    model = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    batch = (torch.from_numpy(X), torch.from_numpy(Y))
    return (pos, jax_vag, model.make_fused_value_and_grad(batch),
            model.make_fused_value_and_grad(batch, fwd_full=False))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def test_batched_leapfrog_matches_jax():
    pos, jax_vag, vag, _ = _problem(0)
    rng = np.random.RandomState(1)
    mom = {k: rng.randn(*v.shape).astype(np.float32) for k, v in pos.items()}
    eps = np.linspace(1e-3, 3e-2, C).astype(np.float32)

    jm = jax_batched_metric(jax.tree_util.tree_map(jnp.ones_like, pos))
    v0, g0 = jax_vag(pos)
    ref = jax_verlet_batched(jax_vag, jm.kinetic_grad)(
        JaxIntegratorState(pos, mom, v0, g0), jnp.asarray(eps))

    tpos = _t(pos)
    m = batched_diagonal_metric(tree_ones_like(tpos))
    tv0, tg0 = vag(tpos)
    out = velocity_verlet_batched(vag, m.kinetic_grad)(
        IntegratorState(tpos, _t(mom), tv0, tg0), torch.from_numpy(eps))

    _close(out.logdensity.numpy(), ref.logdensity, rtol=1e-5)
    for k in ("weights", "bias"):
        _close(out.position[k].numpy(), ref.position[k])
        _close(out.momentum[k].numpy(), ref.momentum[k], atol=1e-4)


@pytest.mark.parametrize("lazy", [False, True])
def test_batched_kernel_step_matches_jax(lazy):
    """Three HMC draws with injected momenta and uniforms; step sizes spread
    so that some chains reject."""
    pos, jax_vag, vag, grad_only = _problem(2)
    L = 4
    eps = np.array([0.01, 0.05, 0.1, 0.15, 0.2, 0.3], np.float32)
    inv_mass_j = jax.tree_util.tree_map(jnp.ones_like, pos)
    jkernel = jhmc.build_batched_kernel(jax_vag, L, grad_fn=jax_vag if lazy else None)
    tkernel = hmc.build_batched_kernel(vag, L, grad_fn=grad_only if lazy else None)

    jstate = jhmc.batched_init(pos, jax_vag)
    tstate = hmc.batched_init(_t(pos), vag)
    inv_mass_t = tree_ones_like(tstate.position)
    decisions = []
    for i in range(3):
        key = jax.random.key(10 + i)
        key_mom, key_accept = jax.random.split(key)
        mom = tree_randn_like(key_mom, pos)      # unit mass: momentum = eps
        u = jax.random.uniform(key_accept, (C,))
        jstate, jinfo = jkernel(key, jstate, jnp.asarray(eps), inv_mass_j)
        tstate, tinfo = tkernel(tstate, torch.from_numpy(eps), inv_mass_t,
                                momentum=_t(mom),
                                uniforms=torch.from_numpy(np.array(u)))
        np.testing.assert_array_equal(tinfo.is_accepted.numpy(),
                                      np.asarray(jinfo.is_accepted))
        # energies are O(600) in f32 (ulp 6e-5), so the energy delta carries
        # ~1e-4 of summation-order noise: accept probs agree to rtol 1e-3
        _close(tinfo.acceptance_prob.numpy(), jinfo.acceptance_prob, rtol=1e-3, atol=1e-6)
        _close(tinfo.energy.numpy(), jinfo.energy, rtol=1e-5)
        _close(tstate.logdensity.numpy(), jstate.logdensity, rtol=1e-5)
        for k in ("weights", "bias"):
            _close(tstate.position[k].numpy(), jstate.position[k])
        decisions.append(tinfo.is_accepted.numpy())
    decisions = np.array(decisions)
    assert decisions.any() and not decisions.all()


def test_kernel_needs_explicit_randomness():
    pos, _, vag, _ = _problem(3)
    kernel = hmc.build_batched_kernel(vag, 2)
    state = hmc.batched_init(_t(pos), vag)
    with pytest.raises(ValueError):
        kernel(state, torch.full((C,), 0.01), tree_ones_like(state.position))
    g = torch.Generator().manual_seed(0)
    new, info = kernel(state, torch.full((C,), 0.01), tree_ones_like(state.position),
                       generator=g)
    assert info.acceptance_prob.shape == (C,)
    assert bool(torch.isfinite(new.logdensity).all())
