"""The plain references against the port at a tiny size on the CPU, float64."""

import numpy as np
import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP, Softmax
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric
from perfbench.harness import spec
from perfbench.yardstick import data

F64 = torch.float64


@pytest.fixture(scope="module")
def softmax_ref():
    return spec.load_module("reference", "softmax-mnist")


@pytest.fixture(scope="module")
def mlp_ref():
    return spec.load_module("reference", "mlp-dropout-mnist")


def test_softmax_log_posterior_matches_port(softmax_ref):
    X, yi = data.synthetic_mnist(3, "cpu", n=200, dim=9, n_classes=4)
    Y = torch.nn.functional.one_hot(yi, 4).to(F64)
    g = torch.Generator().manual_seed(0)
    W = torch.randn((3, 9, 4), generator=g, dtype=F64)
    b = torch.randn((3, 4), generator=g, dtype=F64)
    model = Softmax(dim=9, n_classes=4, alpha=0.7)
    Wl, bl = W.clone().requires_grad_(True), b.clone().requires_grad_(True)
    params = {"weights": Wl, "bias": bl}
    v_port = model.log_prior(params) + model.log_likelihood(params, (X.to(F64), Y))
    gw, gb = torch.autograd.grad(v_port.sum(), [Wl, bl])
    Q = torch.cat([W, b[:, None, :]], dim=1)
    v_ref, g_ref = softmax_ref.log_posterior(Q, softmax_ref.augment(X), Y, 0.7)
    torch.testing.assert_close(v_ref, v_port.detach(), rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(g_ref, torch.cat([gw, gb[:, None, :]], dim=1),
                               rtol=1e-10, atol=1e-9)


def test_softmax_setup_matches_port(softmax_ref):
    X, yi = data.synthetic_mnist(4, "cpu", n=400, dim=12, n_classes=4)
    Y = torch.nn.functional.one_hot(yi, 4).to(torch.float32)
    model = Softmax(dim=12, n_classes=4, alpha=1.0)
    metric, aux, qmap, _ = kron_metric.cached_gn_setup(X, Y, model, 1.0, newton_steps=60,
                                                       n_classes=4, seed=5)
    basis = {"U_g": metric.U_g, "U_a": metric.U_a, "d_aug": metric.d_aug, "qmap": qmap}
    out = softmax_ref.check_whitened(X, Y, 1.0, 60, 5, basis, [], torch.ones(1),
                                     sampler="hmc")
    assert out["map_gap"] < 1e-4 and out["metric_gap"] < 1e-4
    assert out["captured"] == 0


def test_mlp_log_posterior_matches_port(mlp_ref):
    g = torch.Generator().manual_seed(1)
    model = DropoutMLP(dim=7, hidden=5, n_classes=3, alpha=0.5, p_drop=0.2)
    params = {k: v[None].expand((2,) + v.shape).to(F64).clone()
              + 0.1 * torch.randn((2,) + v.shape, generator=g, dtype=F64)
              for k, v in model.init_params(g, "cpu").items()}
    X = torch.rand((2, 6, 7), generator=g, dtype=F64)
    Y = torch.nn.functional.one_hot(torch.randint(0, 3, (2, 6), generator=g), 3).to(F64)
    masks = model.draw_masks(params, X, g)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    v_port = model.log_posterior(leaves, (X, Y), 100, masks)
    g_port = torch.autograd.grad(v_port.sum(), [leaves[k] for k in mlp_ref.KEYS])
    leaves_ref = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    v_ref = mlp_ref.log_posterior(leaves_ref, X, Y, list(masks), 100, 0.5, 0.2)
    g_ref = torch.autograd.grad(v_ref.sum(), [leaves_ref[k] for k in mlp_ref.KEYS])
    torch.testing.assert_close(v_ref, v_port, rtol=1e-12, atol=1e-10)
    for a, b in zip(g_ref, g_port):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-10)


def test_synthetic_data_is_seeded_and_on_the_grid():
    X1, y1 = data.synthetic_mnist(2 ** 33 + 7, "cpu", n=500, dim=20, n_classes=10)
    X2, y2 = data.synthetic_mnist(2 ** 33 + 7, "cpu", n=500, dim=20, n_classes=10)
    X3, _ = data.synthetic_mnist(2 ** 33 + 8, "cpu", n=500, dim=20, n_classes=10)
    assert torch.equal(X1, X2) and torch.equal(y1, y2) and not torch.equal(X1, X3)
    k = X1.numpy() * 256.0
    assert np.array_equal(k, np.round(k)) and X1.min() >= 0 and X1.max() <= 1
    assert torch.equal(X1.to(torch.bfloat16).float(), X1)


def test_nuts_replay_follows_the_port(softmax_ref):
    # the port's lockstep NUTS in float64 on a Gaussian, with its draws
    # injected: the replay must allow every chain's new position, and must
    # not when the port took its leaves with other uniforms
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched

    C, P, depth = 256, 5, 4
    g = torch.Generator().manual_seed(3)
    prec = torch.linspace(0.5, 3.0, P, dtype=F64)
    calls = []

    def vag(pos):
        x = pos["x"]
        v, grad = -0.5 * (prec * x * x).sum(1), -prec * x
        calls.append((x.clone(), v, grad))
        return v, {"x": grad}

    kernel = nuts_batched.build_batched_kernel(vag, max_tree_depth=depth)
    x0 = torch.randn((C, P), generator=g, dtype=F64)
    state = nuts_batched.batched_init({"x": x0}, vag)
    eps = 0.2 + torch.rand((C,), generator=g, dtype=F64)
    draws = nuts_batched.sample_draws(C, P, depth, g, "cpu", F64)

    def replay(used):
        calls.clear()
        new, _ = kernel(state, eps, None, draws=used)
        allowed, undecided, short = softmax_ref.nuts_choice(
            x0, draws.momentum, state.logdensity, state.logdensity_grad["x"], list(calls),
            draws.direction, draws.leaf_uniform, draws.bias_uniform, eps, depth)
        at = torch.stack([(z == new.position["x"]).all(1) for z, _, _ in calls]
                         + [(x0 == new.position["x"]).all(1)], dim=1)
        return (at & allowed).any(dim=1) | undecided, allowed, short

    ok, allowed, short = replay(draws)
    assert bool(ok.all()) and not bool(short.any())
    assert float((allowed.sum(dim=1) == 1).double().mean()) > 0.99
    assert len(calls) > 3
    ok, _, _ = replay(draws._replace(leaf_uniform=torch.zeros_like(draws.leaf_uniform)))
    assert float((~ok).double().mean()) > 0.2
