"""Parity of the port's Kronecker Gauss-Newton metric with the JAX package.

On scikit-learn's digits (1797 x 64, real pixels), the JAX package writes its
metric setup npz and the port loads it, and the other way round, so both
sides use the same eigenbases (an eigenvector's sign is otherwise free).
Everything is f32 on the CPU and differs only in summation order:
rtol 1e-4 with atol 1e-4 * max|ref| on maps and gradients.
"""

import glob
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference.hmc import HMCState as JaxHMCState  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import kron_metric as jkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.hmc import HMCState  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric as tkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import (  # noqa: E402
    load_gn_setup,
    params_from_jax,
)

ALPHA = 1.0
C = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    X, yi = datasets.digits()
    Y = np.eye(10, dtype=np.float32)[yi]
    d = X.shape[1]
    cache = str(tmp_path_factory.mktemp("jax_setup"))
    jmodel = JaxSoftmax(dim=d, n_classes=10, alpha=ALPHA)
    with jax.default_matmul_precision("highest"):
        jmetric, jaux, jqmap, _ = jkm.cached_gn_setup(
            jnp.asarray(X), jnp.asarray(Y), jmodel, alpha=ALPHA, newton_steps=60,
            cache_dir=cache, provenance="sklearn-digits")
    (npz,) = glob.glob(os.path.join(cache, "kron_setup_*.npz"))
    tmetric, taux, tqmap = load_gn_setup(npz, ALPHA, "cpu")
    return dict(X=X, Y=Y, d=d, jmodel=jmodel, jmetric=jmetric, jaux=jaux,
                jqmap=jqmap, tmetric=tmetric, taux=taux, tqmap=tqmap)


def _rand_tree(rng, d, batch=(C,), scale=1.0):
    return {"weights": (scale * rng.randn(*batch, d, 10)).astype(np.float32),
            "bias": (scale * rng.randn(*batch, 10)).astype(np.float32)}


def _close_tree(got, ref):
    for k in ("weights", "bias"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


def test_whiten_unwhiten_match_jax(setup):
    rng = np.random.RandomState(0)
    dq = _rand_tree(rng, setup["d"], scale=0.01)
    e = _rand_tree(rng, setup["d"])
    jm, tm = setup["jmetric"], setup["tmetric"]
    with jax.default_matmul_precision("highest"):
        ref_w = jax.vmap(jm.whiten)(dq)
        ref_u = jax.vmap(jm.unwhiten)(e)
    _close_tree(tm.whiten(params_from_jax(dq, "cpu")), ref_w)
    _close_tree(tm.unwhiten(params_from_jax(e, "cpu")), ref_u)
    # and the two are inverse
    back = tm.whiten(tm.unwhiten(params_from_jax(e, "cpu")))
    _close_tree(back, e)


def test_kinetic_maps_and_laplace_draw_match_jax(setup):
    """kinetic_energy, kinetic_grad (the Newton step's M^-1 g) and
    sample_position with the JAX draw injected."""
    rng = np.random.RandomState(6)
    p = _rand_tree(rng, setup["d"], batch=(), scale=30.0)
    jm, tm = setup["jmetric"], setup["tmetric"]
    key = jax.random.key(7)
    eps = jax.random.normal(key, (setup["d"] + 1, 10), jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref_k = float(jm.kinetic_energy(p))
        ref_g = jm.kinetic_grad(p)
        ref_q = jm.sample_position(key, setup["jqmap"])
    tp = params_from_jax(p, "cpu")
    np.testing.assert_allclose(float(tm.kinetic_energy(tp)), ref_k, rtol=1e-4)
    _close_tree(tm.kinetic_grad(tp), ref_g)
    _close_tree(tm.sample_position(setup["tqmap"], torch.from_numpy(np.array(eps))), ref_q)


def test_unwhiten_transpose_matches_linear_transpose(setup):
    rng = np.random.RandomState(1)
    g = _rand_tree(rng, setup["d"], batch=(), scale=10.0)
    e_example = jax.tree_util.tree_map(jnp.zeros_like, setup["jqmap"])
    with jax.default_matmul_precision("highest"):
        (ref,) = jax.linear_transpose(setup["jmetric"].unwhiten, e_example)(g)
    _close_tree(setup["tmetric"].unwhiten_transpose(params_from_jax(g, "cpu")), ref)


def test_gauge_gibbs_matches_jax(setup):
    rng = np.random.RandomState(2)
    e = _rand_tree(rng, setup["d"])
    grad = _rand_tree(rng, setup["d"])
    logd = rng.randn(C).astype(np.float32) - 100.0
    key = jax.random.key(3)
    kw, kb = jax.random.split(key)      # the JAX move's own draws
    eps_w = jax.random.normal(kw, (C, setup["d"]), jnp.float32)
    eps_b = jax.random.normal(kb, (C,), jnp.float32)
    with jax.default_matmul_precision("highest"):
        jgibbs = jkm.make_whitened_gauge_gibbs(setup["jmetric"], setup["jaux"],
                                               setup["jqmap"])
        ref = jgibbs(key, JaxHMCState(jax.tree_util.tree_map(jnp.asarray, e),
                                      jnp.asarray(logd),
                                      jax.tree_util.tree_map(jnp.asarray, grad)))
    tgibbs = tkm.make_whitened_gauge_gibbs(setup["tmetric"], setup["taux"],
                                           setup["tqmap"])
    got = tgibbs(HMCState(params_from_jax(e, "cpu"), torch.from_numpy(logd),
                          params_from_jax(grad, "cpu")),
                 eps_w=torch.from_numpy(np.array(eps_w)),
                 eps_b=torch.from_numpy(np.array(eps_b)))
    _close_tree(got.position, ref.position)
    _close_tree(got.logdensity_grad, ref.logdensity_grad)
    np.testing.assert_allclose(got.logdensity.numpy(), np.asarray(ref.logdensity),
                               rtol=1e-5)


def test_whitened_fused_vag_matches_jax(setup):
    rng = np.random.RandomState(4)
    E = _rand_tree(rng, setup["d"], scale=0.5)
    with jax.default_matmul_precision("highest"):
        jvag, _ = jkm.make_whitened_fused_vag(
            setup["jmodel"], setup["jmetric"], setup["jqmap"],
            (jnp.asarray(setup["X"]), jnp.asarray(setup["Y"])), use_pallas=False)
        ref_v, ref_g = jvag(E)
    model = Softmax(dim=setup["d"], n_classes=10, alpha=ALPHA)
    batch = (torch.from_numpy(setup["X"]), torch.from_numpy(setup["Y"]))
    vag, grad_only = tkm.make_whitened_fused_vag(model, setup["tmetric"],
                                                 setup["tqmap"], batch)
    v, g = vag(params_from_jax(E, "cpu"))
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=1e-5)
    _close_tree(g, ref_g)
    _close_tree(grad_only(params_from_jax(E, "cpu")), ref_g)


def test_whitened_fused_vag_shares_one_split(setup):
    """make_whitened_fused_vag cuts X's bf16 pieces once for both makers (on
    a CUDA X); its outputs equal the two makers built here with an explicit
    shared split, which the CPU route ignores."""
    from dropout_hamiltonian_montecarlo_tpu_torch.ops.softmax_glm import split_bf16_input

    rng = np.random.RandomState(9)
    E = params_from_jax(_rand_tree(rng, setup["d"], scale=0.5), "cpu")
    model = Softmax(dim=setup["d"], n_classes=10, alpha=ALPHA)
    batch = (torch.from_numpy(setup["X"]), torch.from_numpy(setup["Y"]))
    metric, qmap = setup["tmetric"], setup["tqmap"]
    vag, grad_only = tkm.make_whitened_fused_vag(model, metric, qmap, batch)
    split = split_bf16_input(batch[0])
    fused_q = model.make_fused_value_and_grad(batch, x_split=split)
    fused_g = model.make_fused_value_and_grad(batch, fwd_full=False, x_split=split)
    dQ = metric.unwhiten(E)
    Q = {k: qmap[k][None] + dQ[k] for k in qmap}
    ref_v, ref_G = fused_q(Q)
    v, g = vag(E)
    np.testing.assert_array_equal(v.numpy(), ref_v.numpy())
    for got, ref in ((g, metric.unwhiten_transpose(ref_G)),
                     (grad_only(E), metric.unwhiten_transpose(fused_g(Q)))):
        for k in ("weights", "bias"):
            np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_whitened_call_captures_nothing_off_cuda(setup, use_kernel):
    """On the CPU, with the kernel route or with ``use_kernel=False``, the
    whitened call runs eagerly: no CUDA graph is captured, no kernel launch
    (and so no replay) is counted, and the outputs are the composition's, bit for
    bit, in its layout (views of one packed (C, D+1, K) gradient)."""
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg

    rng = np.random.RandomState(12)
    E = params_from_jax(_rand_tree(rng, setup["d"], scale=0.5), "cpu")
    model = Softmax(dim=setup["d"], n_classes=10, alpha=ALPHA)
    batch = (torch.from_numpy(setup["X"]), torch.from_numpy(setup["Y"]))
    metric, qmap = setup["tmetric"], setup["tqmap"]
    sg.reset_launch_counts()
    captures = tkm.graph_counts["captures"]
    vag, grad_only = tkm.make_whitened_fused_vag(model, metric, qmap, batch,
                                                 use_kernel=use_kernel)
    got = [vag(E), (None, grad_only(E)), vag(E)]
    assert tkm.graph_counts["captures"] == captures
    assert sg.launch_counts == {"value_and_grad": 0, "grad": 0}
    assert sg.forward_items_overlapped == 0
    dQ = metric.unwhiten(E)
    Q = {k: qmap[k][None] + dQ[k] for k in qmap}
    ref_v, ref_G = model.make_fused_value_and_grad(batch, use_kernel=use_kernel)(Q)
    ref_g = metric.unwhiten_transpose(ref_G)
    for value, g in got:
        if value is not None:
            np.testing.assert_array_equal(value.numpy(), ref_v.numpy())
        for k in ("weights", "bias"):
            np.testing.assert_array_equal(g[k].numpy(), ref_g[k].numpy())
            assert g[k].stride() == ref_g[k].stride()


@pytest.mark.parametrize("change, recapture", [
    ("values", False), ("strides", False), ("chains", True), ("classes", True),
    ("dtype", True), ("leaves", True)])
def test_graph_key_decides_replay_or_capture(change, recapture):
    """``graph_key``: a call whose E has the held graph's leaves, shapes,
    dtype and device replays it, whatever its values and strides (the copy
    into the static input takes any layout, as NUTS's unravelled views);
    another chain count, class count, dtype or leaf set captures anew."""
    g = torch.Generator().manual_seed(0)
    E = {"weights": torch.randn((4, 6, 3), generator=g), "bias": torch.randn((4, 3), generator=g)}
    if change == "values":
        F = {k: v + 1.0 for k, v in E.items()}
    elif change == "strides":
        flat = torch.randn((4, 6 * 3 + 3), generator=g)
        F = {"weights": flat[:, :18].view(4, 6, 3), "bias": flat[:, 18:]}
        assert not F["bias"].is_contiguous()
    elif change == "chains":
        F = {k: v[:2] for k, v in E.items()}
    elif change == "classes":
        F = {k: v[..., :2] for k, v in E.items()}
    elif change == "dtype":
        F = {k: v.double() for k, v in E.items()}
    else:
        F = {"weights": E["weights"], "b": E["bias"]}
    assert tkm.graph_key(E) == tkm.graph_key({k: v.clone() for k, v in E.items()})
    assert (tkm.graph_key(F) != tkm.graph_key(E)) == recapture


def test_port_setup_loads_in_jax(setup, tmp_path):
    """The port computes its own setup (Gram eigh, Newton MAP, Fisher), writes
    it, reads it back from the cache, and the JAX package builds the same
    metric from the file; the two independent Newton MAPs agree."""
    X = torch.from_numpy(setup["X"])
    Y = torch.from_numpy(setup["Y"])
    model = Softmax(dim=setup["d"], n_classes=10, alpha=ALPHA)
    metric, aux, qmap, hit = tkm.cached_gn_setup(X, Y, model, ALPHA, cache_dir=str(tmp_path),
                                                 provenance="sklearn-digits")
    assert not hit and set(aux["timings"]) == {"gram_eigh", "newton_map", "class_fisher"}
    metric2, _, qmap2, hit2 = tkm.cached_gn_setup(X, Y, model, ALPHA, cache_dir=str(tmp_path),
                                                  provenance="sklearn-digits")
    assert hit2
    np.testing.assert_array_equal(qmap2["weights"].numpy(), qmap["weights"].numpy())

    (npz,) = glob.glob(str(tmp_path / "kron_setup_torch_*.npz"))
    with np.load(npz) as z:
        assert set(z.files) == {"s_g", "U_g", "s_a", "U_a", "qw", "qb"}
        jmetric = jkm.softmax_gauss_newton_metric(
            jnp.asarray(setup["X"]), 10, alpha=ALPHA, gram=(z["s_g"], z["U_g"]),
            fisher=(z["s_a"], z["U_a"]), augmented=True)
    rng = np.random.RandomState(5)
    dq = _rand_tree(rng, setup["d"], scale=0.01)
    with jax.default_matmul_precision("highest"):
        ref = jax.vmap(jmetric.whiten)(dq)
    _close_tree(metric2.whiten(params_from_jax(dq, "cpu")), ref)
    for k in ("weights", "bias"):
        r = np.asarray(setup["jqmap"][k])
        np.testing.assert_allclose(qmap[k].numpy(), r, atol=1e-3 * np.abs(r).max())


# ---- the non-augmented metric and its builders --------------------------------

def test_gram_eigh_matches_jax(setup):
    X = setup["X"]
    with jax.default_matmul_precision("highest"):
        ref_s, ref_U = jkm.gram_eigh(jnp.asarray(X))
    s, U = tkm.gram_eigh(torch.from_numpy(X))
    assert s.dtype == np.float64 and U.shape == (setup["d"], setup["d"])
    np.testing.assert_allclose(s, ref_s, rtol=1e-4, atol=1e-4 * ref_s.max())
    # the reconstruction is what must agree: an eigenvector's sign is free
    np.testing.assert_allclose((U * s) @ U.T, (ref_U * ref_s) @ ref_U.T,
                               rtol=1e-4, atol=1e-4 * ref_s.max())
    assert float(s.min()) >= 0.0


@pytest.mark.parametrize("variant", ["uniform", "probs", "scaled"])
def test_softmax_gauss_newton_metric_matches_jax(setup, variant):
    """The separate weight / bias blocks, with the uniform class Fisher, the
    empirical one from ``probs=``, and a ``likelihood_scale``; both packages
    get one ``gram=`` (and, for the maps that depend on the eigenbasis, one
    ``fisher=``).  rtol 1e-4, atol 1e-4 max|ref|."""
    X, d = setup["X"], setup["d"]
    rng = np.random.RandomState(8)
    gram = tkm.gram_eigh(torch.from_numpy(X))
    probs = None
    if variant == "probs":
        logits = rng.randn(X.shape[0], 10).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    scale = 2.5 if variant == "scaled" else 1.0
    fisher = tkm.class_fisher_eigh(10, None if probs is None else torch.from_numpy(probs))
    with jax.default_matmul_precision("highest"):
        jm, jaux = jkm.softmax_gauss_newton_metric(
            jnp.asarray(X), 10, ALPHA, likelihood_scale=scale, gram=gram,
            probs=None if probs is None else jnp.asarray(probs), return_aux=True)
        jm_shared = jkm.softmax_gauss_newton_metric(
            jnp.asarray(X), 10, ALPHA, likelihood_scale=scale, gram=gram, fisher=fisher,
            augmented=False)
    tm, taux = tkm.softmax_gauss_newton_metric(
        torch.from_numpy(X), 10, ALPHA, likelihood_scale=scale, gram=gram,
        probs=None if probs is None else torch.from_numpy(probs), return_aux=True)
    assert set(taux) == set(jaux)
    for key in ("s_a", "d_w", "d_b"):
        ref = np.asarray(jaux[key])
        np.testing.assert_allclose(np.asarray(taux[key]), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())

    p = _rand_tree(rng, d, scale=30.0)
    tp = params_from_jax(p, "cpu")
    with jax.default_matmul_precision("highest"):
        ref_k = jax.vmap(jm.kinetic_energy)(p)
        ref_g = jax.vmap(jm.kinetic_grad)(p)
    np.testing.assert_allclose(tm.kinetic_energy(tp).numpy(), np.asarray(ref_k), rtol=1e-4)
    _close_tree(tm.kinetic_grad(tp), ref_g)
    # the JAX package ignores fisher= without augmented=True; hold the
    # eigenbasis maps against each other only where both used the same basis
    if variant != "probs":
        dq = _rand_tree(rng, d, scale=0.01)
        with jax.default_matmul_precision("highest"):
            ref_w = jax.vmap(jm_shared.whiten)(dq)
        got_w = tm.whiten(params_from_jax(dq, "cpu"))
        back = tm.unwhiten(got_w)
        _close_tree(back, dq)
        np.testing.assert_allclose(
            sum(float((v ** 2).sum()) for v in got_w.values()),
            sum(float((np.asarray(v) ** 2).sum()) for v in ref_w.values()), rtol=1e-4)
    # a momentum draw has covariance M: K(p) averages D K / 2 + K / 2 per chain
    gen = torch.Generator().manual_seed(0)
    like = {"weights": torch.zeros(200, d, 10), "bias": torch.zeros(200, 10)}
    k_mean = float(tm.kinetic_energy(tm.sample_momentum(like, gen)).mean())
    assert abs(k_mean / (0.5 * (d * 10 + 10)) - 1.0) < 0.05
    # the Laplace draw: q = mean + M^-1/2 eps
    eps = {k: torch.ones_like(v[:2]) for k, v in like.items()}
    q = tm.sample_position({k: v[:2] for k, v in like.items()}, eps)
    _close_tree(tm.whiten(q), {k: np.ones(v.shape, np.float32) for k, v in eps.items()})


def test_softmax_gauss_newton_metric_augmented_is_the_kron_metric(setup):
    X = torch.from_numpy(setup["X"])
    gram = tkm.gram_eigh_augmented(X)
    fisher = tkm.class_fisher_eigh(10)
    metric, aux = tkm.softmax_gauss_newton_metric(X, 10, ALPHA, likelihood_scale=2.0,
                                                  gram=gram, fisher=fisher, augmented=True,
                                                  return_aux=True)
    assert isinstance(metric, tkm.KronMetric) and aux["augmented"] is True
    with jax.default_matmul_precision("highest"):
        jm, jaux = jkm.softmax_gauss_newton_metric(
            jnp.asarray(setup["X"]), 10, ALPHA, likelihood_scale=2.0, gram=gram,
            fisher=fisher, augmented=True, return_aux=True)
        rng = np.random.RandomState(3)
        dq = _rand_tree(rng, setup["d"], scale=0.01)
        ref = jax.vmap(jm.whiten)(dq)
    _close_tree(metric.whiten(params_from_jax(dq, "cpu")), ref)
    np.testing.assert_allclose(aux["s_a"], np.asarray(jaux["s_a"]), atol=1e-12)
    np.testing.assert_allclose(aux["d_w"], np.asarray(jaux["d_w"]), rtol=1e-5)
