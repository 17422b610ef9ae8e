"""Parity of the port's lockstep chain-batched NUTS with the JAX package.

JAX's threefry streams cannot be reproduced in PyTorch, so ``_replay_draws``
makes every random number of one JAX step with the key splits the JAX
kernel makes (inference/nuts_batched.py: per-chain keys, (momentum, tree)
split, per-depth (direction, subtree, bias, next) splits, per-leaf
(next, multinomial) splits) and hands them to the port as a ``NUTSDraws``.
Both sides are f32 on the CPU and differ only in summation order: tree
sizes, depths, divergence and accept flags equal; positions and log
densities within rtol 1e-5, atol 1e-5.  Whole runs are compared
statistically.
"""

import glob

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import nuts as jnuts  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference import nuts_batched as jnb  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import MVNGaussian  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import kron_metric as jkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.adaptation import (  # noqa: E402
    dual_averaging_init as jax_da_init,
    dual_averaging_update as jax_da_update,
)
from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics import summarize  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts, nuts_batched  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.warmup import run_warmup  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric as tkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops.tree import tree_ones_like  # noqa: E402

MU = np.array([1.0, -2.0, 0.5], np.float32)
A = np.array([[1.0, 0.0, 0.0], [0.6, 0.8, 0.0], [-0.3, 0.4, 0.9]], np.float32)
COV = (A @ A.T + 0.2 * np.eye(3)).astype(np.float32)
ALPHA, ROWS = 1.0, 400


def _replay_draws(key, num_chains, dim, max_depth):
    """Every random number of one JAX ``nuts_batched`` step, as NUTSDraws."""
    split2 = jax.vmap(lambda k: tuple(jax.random.split(k)))
    unif = jax.vmap(jax.random.uniform)
    k_mom, keys = split2(jax.random.split(key, num_chains))
    momentum = jax.vmap(lambda k: jax.random.normal(k, (dim,)))(k_mom)
    direction = np.zeros((max_depth, num_chains), bool)
    bias = np.zeros((max_depth, num_chains), np.float32)
    leaf = np.zeros((max_depth, 2 ** (max_depth - 1), num_chains), np.float32)
    for d in range(max_depth):
        k_dir, rest = split2(keys)
        k_sub, rest = split2(rest)
        k_bias, keys = split2(rest)
        direction[d] = np.asarray(jax.vmap(jax.random.bernoulli)(k_dir))
        bias[d] = np.asarray(unif(k_bias))
        for i in range(2 ** d):
            k_sub, k_mult = split2(k_sub)
            leaf[d, i] = np.asarray(unif(k_mult))
    return nuts_batched.NUTSDraws(torch.from_numpy(np.array(momentum)),
                                  torch.from_numpy(direction), torch.from_numpy(leaf),
                                  torch.from_numpy(bias))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _mvn_problem(num_chains, seed):
    model = MVNGaussian(jnp.asarray(MU), jnp.asarray(COV))
    jvag = jax.vmap(jax.value_and_grad(model.make_logdensity()))
    pos = {"x": np.asarray(MU + np.random.RandomState(seed).randn(num_chains, 3),
                           np.float32)}
    prec = torch.from_numpy(np.linalg.inv(COV.astype(np.float64)).astype(np.float32))
    mu = torch.from_numpy(MU)
    const = float(-0.5 * (3 * np.log(2 * np.pi) + np.linalg.slogdet(COV)[1]))

    def tvag(p):
        diff = p["x"] - mu
        g = -diff @ prec
        return const + 0.5 * (diff * g).sum(dim=1), {"x": g}

    return pos, jvag, tvag


@pytest.fixture(scope="module")
def digits_setup(tmp_path_factory):
    """The whitened softmax posterior on the first 400 rows of digits: one
    setup npz written by the JAX package and read by the port."""
    X, yi = datasets.digits()
    X, yi = X[:ROWS], yi[:ROWS]
    Y = np.eye(10, dtype=np.float32)[yi]
    jmodel = JaxSoftmax(dim=X.shape[1], n_classes=10, alpha=ALPHA)
    cache = tmp_path_factory.mktemp("setup")
    with jax.default_matmul_precision("highest"):
        jmetric, _, jqmap, _ = jkm.cached_gn_setup(
            jnp.asarray(X), jnp.asarray(Y), jmodel, alpha=ALPHA, newton_steps=60,
            cache_dir=str(cache), provenance="digits-400")
        jvag_raw, _ = jkm.make_whitened_fused_vag(jmodel, jmetric, jqmap, (X, Y),
                                                  use_pallas=False)
    (npz,) = glob.glob(str(cache / "kron_setup_*.npz"))
    metric, _, qmap = tkm.load_gn_setup(npz, ALPHA, "cpu")
    model = Softmax(dim=X.shape[1], n_classes=10, alpha=ALPHA)
    tvag, _ = tkm.make_whitened_fused_vag(model, metric, qmap,
                                          (torch.from_numpy(X), torch.from_numpy(Y)))

    def jvag(p):
        with jax.default_matmul_precision("highest"):
            return jvag_raw(p)

    return X.shape[1], jvag, tvag


_JAX_STEPS = {}


def _jax_step(name, jvag, max_depth):
    """One jitted JAX step per (problem, depth), shared across cases."""
    if (name, max_depth) not in _JAX_STEPS:
        _JAX_STEPS[(name, max_depth)] = jax.jit(
            jnb.build_batched_kernel(jvag, max_tree_depth=max_depth))
    return _JAX_STEPS[(name, max_depth)]


def _compare_step(jstep, jvag, tvag, pos, eps, max_depth, seed):
    chains = eps.shape[0]
    inv_mass = jax.tree_util.tree_map(jnp.ones_like, pos)
    jstate = jnb.batched_init(pos, jvag)
    key = jax.random.key(seed)
    jnew, jinfo = jstep(key, jstate, jnp.asarray(eps), inv_mass)

    tpos = _t(pos)
    tstate = nuts_batched.batched_init(tpos, tvag)
    dim = sum(int(np.prod(v.shape[1:])) for v in pos.values())
    draws = _replay_draws(key, chains, dim, max_depth)
    kernel = nuts_batched.build_batched_kernel(tvag, max_tree_depth=max_depth)
    tnew, tinfo = kernel(tstate, torch.from_numpy(eps), tree_ones_like(tpos), draws=draws)

    for f in ("num_integration_steps", "depth", "is_divergent", "is_accepted"):
        np.testing.assert_array_equal(getattr(tinfo, f).numpy(), np.asarray(getattr(jinfo, f)),
                                      err_msg=f)
    # an accept prob min(1, exp(E0 - E)) moves by up to p |d(E0 - E)|, and
    # f32 energies carry an ulp each: 1e-5, or 2 ulp of the largest energy
    # where that is more (whitened softmax: |E| ~ 1e3, ulp 6.1e-5)
    e_max = float(np.abs(np.asarray(jinfo.energy)).max())
    atol = max(1e-5, 2 * float(np.spacing(np.float32(e_max))))
    np.testing.assert_allclose(tinfo.acceptance_prob.numpy(), np.asarray(jinfo.acceptance_prob),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(tnew.logdensity.numpy(), np.asarray(jnew.logdensity),
                               rtol=1e-5, atol=1e-5)
    for k in pos:
        np.testing.assert_allclose(tnew.position[k].numpy(), np.asarray(jnew.position[k]),
                                   rtol=1e-5, atol=1e-5)
    return tinfo, kernel


def test_bit_helpers_match_jax():
    n = jnp.arange(2048, dtype=jnp.int32)
    bits = np.asarray(jax.vmap(jnuts._bit_count)(n))
    ones = np.asarray(jax.vmap(jnuts._trailing_ones)(n))
    assert [nuts._bit_count(i) for i in range(2048)] == bits.tolist()
    assert [nuts._trailing_ones(i) for i in range(2048)] == ones.tolist()


@pytest.mark.parametrize("case", ["mvn", "mvn-diverging"])
def test_one_step_matches_jax_mvn(case):
    pos, jvag, tvag = _mvn_problem(8, seed=0)
    if case == "mvn":
        eps = np.linspace(0.2, 0.6, 8).astype(np.float32)
    else:   # leapfrog is unstable above ~2 sqrt(min eigenvalue of COV)
        eps = np.array([0.3, 2.5, 3.0, 4.0, 0.5, 5.0, 3.5, 6.0], np.float32)
    tinfo, _ = _compare_step(_jax_step("mvn", jvag, 6), jvag, tvag, pos, eps, 6, seed=1)
    leaves = tinfo.num_integration_steps.numpy()
    if case == "mvn":
        assert not tinfo.is_divergent.any() and (leaves > 1).any()
    else:
        assert tinfo.is_divergent.any() and not tinfo.is_divergent.all()


def test_one_step_matches_jax_whitened_softmax(digits_setup):
    d, jvag, tvag = digits_setup
    rng = np.random.RandomState(2)
    pos = {"weights": rng.randn(4, d, 10).astype(np.float32),
           "bias": rng.randn(4, 10).astype(np.float32)}
    eps = np.array([0.1, 0.2, 0.3, 0.45], np.float32)
    tinfo, _ = _compare_step(_jax_step("digits", jvag, 4), jvag, tvag, pos, eps, 4, seed=3)
    assert (tinfo.num_integration_steps.numpy() > 1).all()


def test_late_flag_read_is_exact():
    """Reading the any-chain-unmasked flag one leaf late gives bit-identical
    outputs to the eager read, at the cost of at most one masked leaf."""
    pos, _, tvag = _mvn_problem(8, seed=4)
    tpos = _t(pos)
    state = nuts_batched.batched_init(tpos, tvag)
    gen = torch.Generator().manual_seed(0)
    extra = []
    for eps in (0.05, 0.5, 1.2):   # 0.05: trees at the cap; 1.2: short trees
        draws = nuts_batched.sample_draws(8, 3, 6, gen, "cpu")
        outs = []
        for lag in (0, 1):
            kernel = nuts_batched.build_batched_kernel(tvag, max_tree_depth=6, sync_lag=lag)
            new, info = kernel(state, torch.full((8,), eps), None, draws=draws)
            outs.append((new, info, kernel.leaves_executed))
        (n0, i0, l0), (n1, i1, l1) = outs
        assert torch.equal(n0.position["x"], n1.position["x"])
        assert torch.equal(n0.logdensity, n1.logdensity)
        for a, b in zip(i0, i1):
            assert torch.equal(a, b)
        # the eager loop runs exactly the leaves the longest tree needs
        assert l0 >= int(i0.num_integration_steps.max())
        extra.append(l1 - l0)
    assert extra[0] == 0 and extra[-1] == 1, extra


def test_mvn_moments_with_warmup():
    """Warmup + 300 draws recover the MVN's moments, with the acceptance
    band of tests/test_nuts_batched.py::test_batched_nuts_mvn_moments_with_warmup."""
    chains, draws = 16, 300
    pos, _, tvag = _mvn_problem(chains, seed=5)
    kernel = nuts_batched.build_batched_kernel(tvag, max_tree_depth=8)
    gen = torch.Generator().manual_seed(1)
    state = nuts_batched.batched_init(_t(pos), tvag)
    warm = run_warmup(kernel, state, 300, initial_step_size=torch.full((chains,), 0.3),
                      target_acceptance=0.8, adapt_mass=False, generator=gen)
    st, xs, infos = warm.state, [], []
    for _ in range(draws):
        st, info = kernel(st, warm.step_size, warm.inv_mass, generator=gen)
        xs.append(st.position["x"])
        infos.append(info)
    x = torch.stack(xs).numpy()                          # (draws, chains, 3)
    flat = x.reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), MU, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.35)
    acc = float(torch.stack([i.acceptance_prob for i in infos]).mean())
    assert 0.6 < acc < 0.95
    assert float(torch.stack([i.is_divergent for i in infos]).float().mean()) < 0.01
    assert float(torch.stack([i.depth for i in infos]).float().mean()) < 7.5
    agg = summarize({"x": torch.from_numpy(np.swapaxes(x, 0, 1).copy())})["aggregate"]
    assert float(agg["max_rhat"]) < 1.02
    assert float(agg["min_ess"]) > 500


def test_digits_statistical_parity(digits_setup):
    """Both packages: 20 warmup steps of per-chain dual averaging and 40
    draws on the whitened digits posterior, 4 chains, depth cap 4."""
    d, jvag, tvag = digits_setup
    chains, warmup, draws, target = 4, 20, 40, 0.65
    jstep = _jax_step("digits", jvag, 4)
    e0 = np.random.RandomState(6).randn(chains, d * 10 + 10).astype(np.float32)
    pos = {"weights": e0[:, 10:].reshape(chains, d, 10), "bias": e0[:, :10]}

    inv_mass = jax.tree_util.tree_map(jnp.ones_like, pos)
    state = jnb.batched_init(pos, jvag)
    da = jax_da_init(jnp.full((chains,), 0.1))
    key = jax.random.key(7)
    for t in range(warmup):
        state, info = jstep(jax.random.fold_in(key, t), state, jnp.exp(da.log_step), inv_mass)
        da = jax_da_update(da, info.acceptance_prob, target)
    j_step = np.asarray(jnp.exp(da.log_step_avg))
    j_acc = []
    for t in range(draws):
        state, info = jstep(jax.random.fold_in(key, warmup + t), state, jnp.asarray(j_step),
                            inv_mass)
        j_acc.append(np.asarray(info.acceptance_prob))

    kernel = nuts_batched.build_batched_kernel(tvag, max_tree_depth=4)
    gen = torch.Generator().manual_seed(8)
    tstate = nuts_batched.batched_init(_t(pos), tvag)
    warm = run_warmup(kernel, tstate, warmup, initial_step_size=torch.full((chains,), 0.1),
                      target_acceptance=target, adapt_mass=False, generator=gen)
    st, t_acc = warm.state, []
    for _ in range(draws):
        st, info = kernel(st, warm.step_size, warm.inv_mass, generator=gen)
        t_acc.append(info.acceptance_prob)
    t_acc = float(torch.stack(t_acc).mean())
    assert abs(t_acc - float(np.mean(j_acc))) < 0.1, (t_acc, np.mean(j_acc))
    ratio = float(warm.step_size.median()) / float(np.median(j_step))
    assert 1 / 1.5 < ratio < 1.5, ratio
    assert bool(torch.isfinite(st.logdensity).all())


def test_kernel_needs_explicit_randomness():
    pos, _, tvag = _mvn_problem(2, seed=9)
    state = nuts_batched.batched_init(_t(pos), tvag)
    kernel = nuts_batched.build_batched_kernel(tvag, max_tree_depth=3)
    with pytest.raises(ValueError, match="generator"):
        kernel(state, torch.full((2,), 0.3), None)
    with pytest.raises(ValueError):
        nuts_batched.build_batched_kernel(tvag, sync_lag=2)
