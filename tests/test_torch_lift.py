"""The chain axis: tree helpers against the JAX package's, the two routes of
``lift_value_and_grad`` against each other, and the state converters.

Tolerances: rtol 1e-5 (f32 on the CPU, sums in another order); the softmax
log density over 400 rows rtol 1e-5, its gradient atol 1e-4.
"""

from typing import NamedTuple

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.ops import adaptation as jad  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import tree as jtree  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import models  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import adaptation as tad  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import tree  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.integrators import (  # noqa: E402
    IntegratorState,
    lift_value,
    lift_value_and_grad,
    new_integrator_state,
    trajectory,
    velocity_verlet,
)
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402


class _Other(NamedTuple):
    x: float


def _pair(seed):
    rng = np.random.RandomState(seed)
    a = {"w": rng.randn(3, 2).astype(np.float32), "b": rng.randn(2).astype(np.float32)}
    return a, {k: torch.from_numpy(v) for k, v in a.items()}


def test_tree_helpers_match_jax():
    (a, ta), (b, tb) = _pair(0), _pair(1)
    for name in ("tree_sub", "tree_add", "tree_mul"):
        got, ref = getattr(tree, name)(ta, tb), getattr(jtree, name)(a, b)
        for k in a:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
    for k in a:
        np.testing.assert_allclose(tree.tree_scale(ta, 0.3)[k].numpy(),
                                   np.asarray(jtree.tree_scale(a, 0.3)[k]), rtol=1e-6)
        np.testing.assert_allclose(tree.tree_axpy(0.3, ta, tb)[k].numpy(),
                                   np.asarray(jtree.tree_axpy(0.3, a, b)[k]), rtol=1e-6)
        assert not tree.tree_zeros_like(ta)[k].any() and bool((tree.tree_ones_like(ta)[k] == 1).all())
        assert torch.equal(tree.tree_where(torch.tensor(True), ta, tb)[k], ta[k])
        assert torch.equal(tree.tree_where(torch.tensor(False), ta, tb)[k], tb[k])
    np.testing.assert_allclose(float(tree.tree_dot(ta, tb)), float(jtree.tree_dot(a, b)),
                               rtol=1e-5)
    assert tree.tree_size(ta) == jtree.tree_size(a) == 8
    flat, unravel = tree.tree_ravel(ta)
    jflat, _ = jtree.tree_ravel(a)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))   # sorted keys: b, w
    back = unravel(flat)
    assert all(torch.equal(back[k], ta[k]) for k in ta)


def _unmarked(fn):
    """The same log density without the ``chain_batched`` mark: it goes
    through vmap of grad_and_value."""
    return lambda params: fn(params)


@pytest.mark.parametrize("name", ["logistic", "poisson", "mvn", "softmax"])
def test_both_lift_routes_agree(name):
    rng = np.random.RandomState(2)
    c = 4
    if name == "mvn":
        model = models.MVNGaussian(np.array([1.0, -1.0], np.float32),
                                   np.array([[1.5, 0.5], [0.5, 1.5]], np.float32))
        batch, pos = None, {"x": rng.randn(c, 2).astype(np.float32)}
    elif name == "softmax":
        model = models.Softmax(dim=6, n_classes=3, alpha=0.5)
        X = rng.randn(400, 6).astype(np.float32)
        Y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, size=400)]
        batch = (torch.from_numpy(X), torch.from_numpy(Y))
        pos = {"weights": (0.3 * rng.randn(c, 6, 3)).astype(np.float32),
               "bias": (0.1 * rng.randn(c, 3)).astype(np.float32)}
    else:
        model = getattr(models, name.capitalize())(dim=5, alpha=0.2)
        X = rng.randn(100, 5).astype(np.float32)
        y = rng.poisson(1.5, size=100).astype(np.float32) if name == "poisson" \
            else (rng.rand(100) < 0.5).astype(np.float32)
        batch = (torch.from_numpy(X), torch.from_numpy(y))
        pos = {"weights": (0.3 * rng.randn(c, 5)).astype(np.float32),
               "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    tpos = {k: torch.from_numpy(v) for k, v in pos.items()}
    fn = model.make_logdensity(batch)
    assert fn.chain_batched
    v1, g1 = lift_value_and_grad(fn)(tpos)
    v2, g2 = lift_value_and_grad(_unmarked(fn))(tpos)
    assert v1.shape == (c,) and not v1.requires_grad and not g1[next(iter(g1))].requires_grad
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=1e-5)
    np.testing.assert_allclose(lift_value(fn)(tpos).numpy(), lift_value(_unmarked(fn))(tpos).numpy(),
                               rtol=1e-5)
    for k in pos:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-4, atol=1e-4)
    if name == "softmax":   # and the plain two-GEMM version of the fused op
        ll, gw, gb = sg.softmax_value_and_grad_plain(batch[0], batch[1], tpos["weights"],
                                                     tpos["bias"])
        prior = sg.log_prior_batched(tpos["weights"], tpos["bias"], 0.5)
        np.testing.assert_allclose(v1.numpy(), (ll + prior).numpy(), rtol=1e-5)
        np.testing.assert_allclose(g1["weights"].numpy(), (gw - 0.5 * tpos["weights"]).numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(g1["bias"].numpy(), (gb - 0.5 * tpos["bias"]).numpy(),
                                   atol=1e-4)


def test_lift_gives_zero_gradient_for_an_unused_leaf():
    def fn(p):
        return -(p["x"] ** 2).sum(dim=-1)
    fn.chain_batched = True
    pos = {"x": torch.randn(3, 2), "unused": torch.randn(3, 4)}
    for f in (fn, _unmarked(fn)):
        _, g = lift_value_and_grad(f)(pos)
        assert not g["unused"].any() and g["unused"].shape == (3, 4)
        np.testing.assert_allclose(g["x"].numpy(), (-2 * pos["x"]).numpy(), rtol=1e-6)


def test_per_chain_trajectory_equals_fixed_lengths():
    """``trajectory`` with a (C,) count: chain c ends where a fixed run of its
    own count ends."""
    model = models.MVNGaussian(np.zeros(2, np.float32),
                               np.array([[1.5, 0.5], [0.5, 1.5]], np.float32))
    ld = model.make_logdensity()
    g = torch.Generator().manual_seed(0)
    pos = {"x": torch.randn((4, 2), generator=g)}
    mom = {"x": torch.randn((4, 2), generator=g)}
    start = new_integrator_state(ld, pos, mom)
    assert isinstance(start, IntegratorState) and start.logdensity.shape == (4,)
    step = velocity_verlet(ld, lambda p: p)
    eps = torch.tensor([0.1, 0.2, 0.3, 0.4])
    counts = torch.tensor([1, 5, 3, 5], dtype=torch.int32)
    end = trajectory(step, counts, max_steps=5)(start, eps)
    for c, n in enumerate(counts.tolist()):
        fixed = trajectory(step, n)(start, eps)
        for got, ref in zip(end, fixed):
            got, ref = (got["x"], ref["x"]) if isinstance(got, dict) else (got, ref)
            assert torch.equal(got[c], ref[c])
    with pytest.raises(ValueError, match="max_steps"):
        trajectory(step, counts)


def test_dual_averaging_state_converts_from_jax():
    jda = jad.dual_averaging_update(jad.dual_averaging_init(jnp.asarray([0.1, 0.3])),
                                    jnp.asarray([0.9, 0.4]))
    tda = params_from_jax(jda, "cpu")
    assert isinstance(tda, tad.DualAveragingState) and tda.log_step.shape == (2,)
    one = params_from_jax(jad.dual_averaging_init(0.1), "cpu", add_chain_axis=True)
    assert one.log_step.shape == (1,)
    ref = tad.dual_averaging_update(tad.dual_averaging_init(torch.tensor([0.1, 0.3])),
                                    torch.tensor([0.9, 0.4]))
    for f in tad.DualAveragingState._fields:
        np.testing.assert_allclose(getattr(tda, f).numpy(), getattr(ref, f).numpy(), rtol=1e-6)
    with pytest.raises(TypeError, match="no counterpart"):
        params_from_jax(_Other(1.0), "cpu")
