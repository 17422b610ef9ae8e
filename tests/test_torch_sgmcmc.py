"""Parity of the port's SG-MCMC (SGLD, SGHMC, the schedules and the
minibatch run loop) with the JAX package, on the CPU in f32.

One step with replayed randomness: every random number of a JAX step is made
with the key splits the JAX kernel makes (inference/sgmcmc.py: SGLD
``split(key)`` -> (noise, mask) keys; SGHMC ``split(key)`` -> (momentum,
noise) keys, ``split(k_noise, L)`` per inner step, each split again into
(noise, mask) when keyed, and ``fold_in(k_mom, 1)`` for the final value's
mask; ``tree_randn_like`` for every normal dict; the MLP's three-way split
for the masks) and handed to the port as one ``SGMCMCDraws``.  Positions,
momenta and log densities agree within rtol 1e-5 (atol 1e-6: summation
order).  The run loop is replayed the same way over several steps.  The
statistical tests are the JAX package's own (tests/test_sgmcmc.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import sgmcmc as jsg  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import DropoutMLP as JaxMLP  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.tree import (  # noqa: E402
    tree_randn_like as jax_randn_like,
)
from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgmcmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import (  # noqa: E402
    DropoutMasks,
    DropoutMLP,
    Softmax,
)
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
D, H, K, B, C, N = 10, 16, 3, 32, 3, 300
ALPHA, P_DROP = 0.1, 0.2


@pytest.fixture(autouse=True)
def one_thread():
    """Loops of thousands of tiny ops: one intra-op thread is as fast alone
    and does not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D).astype(np.float32)
    yi = (X @ rng.randn(D, K)).argmax(-1)
    y = np.eye(K, dtype=np.float32)[yi]
    shapes = {"W1": (D, H), "b1": (H,), "W2": (H, H), "b2": (H,), "W3": (H, K), "b3": (K,)}
    params = {k: (0.3 * rng.randn(*((C,) + s))).astype(np.float32) for k, s in shapes.items()}
    return (JaxMLP(D, H, K, alpha=ALPHA, p_drop=P_DROP),
            DropoutMLP(D, H, K, alpha=ALPHA, p_drop=P_DROP), X, y, yi, params)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _stack_t(trees):
    """Per-chain numpy dicts (or tuples) -> one torch tree, chain axis first."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: torch.from_numpy(np.stack([t[k] for t in trees])) for k in first}
    return DropoutMasks(*(torch.from_numpy(np.stack([t[i] for t in trees])) for i in range(3)))


def _masks(key):
    return tuple(np.array(jax.random.bernoulli(k, 1.0 - P_DROP, (B, H)))
                 for k in jax.random.split(key, 3))


def sgld_replay(key, q, keyed):
    """(noise, masks) of one chain's JAX SGLD step from its key."""
    k_mask = None
    if keyed:
        key, k_mask = jax.random.split(key)
    return [_np(jax_randn_like(key, q))], ([_masks(k_mask)] if keyed else [])


def sghmc_replay(key, q, keyed, num_leapfrog, refresh):
    """(noise per inner step, momentum, masks) of one chain's JAX SGHMC step."""
    k_mom, k_noise = jax.random.split(key)
    momentum = _np(jax_randn_like(k_mom, q)) if refresh else None
    noise, masks = [], []
    for k in jax.random.split(k_noise, num_leapfrog):
        if keyed:
            k, k_mask = jax.random.split(k)
            masks.append(_masks(k_mask))
        noise.append(_np(jax_randn_like(k, q)))
    if keyed:
        masks.append(_masks(jax.random.fold_in(k_mom, 1)))
    return noise, momentum, masks


def _draws(per_chain, indices=None):
    """Per-chain replays [(noise list, momentum, masks list)] -> SGMCMCDraws."""
    noise = tuple(_stack_t([r[0][i] for r in per_chain]) for i in range(len(per_chain[0][0])))
    momentum = None if per_chain[0][1] is None else _stack_t([r[1] for r in per_chain])
    masks = tuple(_stack_t([r[2][i] for r in per_chain]) for i in range(len(per_chain[0][2])))
    return sgmcmc.SGMCMCDraws(indices=indices, noise=noise, momentum=momentum, masks=masks)


def _assert_tree_close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}[{k}]")


def _chain_batches(X, y, seed):
    idx = np.random.RandomState(seed).randint(0, N, size=(C, B))
    return X[idx], y[idx]


@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "keyed"])
def test_sgld_step_matches_vmapped_jax(keyed):
    jm, tm, X, y, _, params = _problem()
    Xb, yb = _chain_batches(X, y, 1)
    eps = 1e-4
    jkernel = jsg.build_sgld_kernel(jm.make_batched_logdensity(N, dropout=keyed),
                                    temperature=0.7, keyed=keyed)
    tkernel = sgmcmc.build_sgld_kernel(tm.make_batched_logdensity(N, dropout=keyed),
                                       temperature=0.7, keyed=keyed)
    jstate = jax.vmap(jsg.sgld_init)(params)
    tstate = sgmcmc.sgld_init(params_from_jax(params, "cpu"))
    batch = (torch.from_numpy(Xb), torch.from_numpy(yb))
    for i in range(2):
        keys = jax.random.split(jax.random.key(20 + i), C)
        per = [sgld_replay(keys[c], {k: v[c] for k, v in jstate.position.items()}, keyed)
               for c in range(C)]
        draws = _draws([(r[0], None, r[1]) for r in per])
        jstate, jinfo = jax.vmap(jkernel, in_axes=(0, 0, 0, None))(
            keys, jstate, (jnp.asarray(Xb), jnp.asarray(yb)), eps)
        tstate, tinfo = tkernel(tstate, batch, eps, draws=draws)
        _assert_tree_close(tstate.position, jstate.position, "position")
        np.testing.assert_allclose(tstate.logdensity.numpy(), np.asarray(jstate.logdensity),
                                   rtol=RTOL)
        np.testing.assert_allclose(tinfo.logdensity.numpy(), np.asarray(jinfo.logdensity),
                                   rtol=RTOL)
        assert float(tinfo.step_size) == pytest.approx(eps)
    one = params_from_jax(jax.tree_util.tree_map(lambda a: a[0], jstate), "cpu",
                          add_chain_axis=True)
    assert isinstance(one, sgmcmc.SGLDState) and one.logdensity.shape == (1,)
    assert one.position["W1"].shape == (1, D, H)


@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "keyed"])
@pytest.mark.parametrize("refresh", [False, True], ids=["persistent", "refresh"])
@pytest.mark.parametrize("num_leapfrog", [1, 3])
def test_sghmc_step_matches_vmapped_jax(num_leapfrog, refresh, keyed):
    jm, tm, X, y, _, params = _problem()
    Xb, yb = _chain_batches(X, y, 2)
    eps, kw = 2e-4, dict(friction=1.5, temperature=0.8, num_leapfrog=num_leapfrog,
                         refresh_momentum=refresh, keyed=keyed)
    jkernel = jsg.build_sghmc_kernel(jm.make_batched_logdensity(N, dropout=keyed), **kw)
    tkernel = sgmcmc.build_sghmc_kernel(tm.make_batched_logdensity(N, dropout=keyed), **kw)
    jstate = jax.vmap(jsg.sghmc_init)(params)
    tstate = sgmcmc.sghmc_init(params_from_jax(params, "cpu"))
    batch = (torch.from_numpy(Xb), torch.from_numpy(yb))
    for i in range(2):     # the second step starts from a non-zero momentum
        keys = jax.random.split(jax.random.key(40 + i), C)
        per = [sghmc_replay(keys[c], {k: v[c] for k, v in jstate.position.items()}, keyed,
                            num_leapfrog, refresh) for c in range(C)]
        jstate, jinfo = jax.vmap(jkernel, in_axes=(0, 0, 0, None))(
            keys, jstate, (jnp.asarray(Xb), jnp.asarray(yb)), eps)
        tstate, tinfo = tkernel(tstate, batch, eps, draws=_draws(per))
        _assert_tree_close(tstate.position, jstate.position, "position")
        _assert_tree_close(tstate.momentum, jstate.momentum, "momentum")
        np.testing.assert_allclose(tstate.logdensity.numpy(), np.asarray(jstate.logdensity),
                                   rtol=RTOL)
        np.testing.assert_allclose(tinfo.logdensity.numpy(), np.asarray(jinfo.logdensity),
                                   rtol=RTOL)
    one = params_from_jax(jax.tree_util.tree_map(lambda a: a[0], jstate), "cpu",
                          add_chain_axis=True)
    assert isinstance(one, sgmcmc.SGHMCState) and one.momentum["b3"].shape == (1, K)


def test_final_value_uses_a_mask_no_inner_step_used():
    """SGHMC's ``state.logdensity`` is the value under the LAST mask set of
    the draws, at the final position."""
    _, tm, X, y, _, params = _problem()
    ld = tm.make_batched_logdensity(N, dropout=True)
    kernel = sgmcmc.build_sghmc_kernel(ld, num_leapfrog=2, keyed=True)
    state = sgmcmc.sghmc_init(params_from_jax(params, "cpu"))
    batch = tuple(torch.from_numpy(a) for a in _chain_batches(X, y, 3))
    draws = kernel.draw(state, batch, torch.Generator().manual_seed(0))
    assert len(draws.noise) == 2 and len(draws.masks) == 3 and draws.momentum is None
    new, info = kernel(state, batch, 1e-4, draws=draws)
    want = ld(new.position, batch, draws.masks[2])
    np.testing.assert_allclose(new.logdensity.numpy(), want.numpy(), rtol=1e-6)
    other = ld(new.position, batch, draws.masks[1])
    assert not np.allclose(other.numpy(), want.numpy(), rtol=1e-4)


def test_unmarked_logdensity_goes_through_vmap():
    """One chain's log density (params dict -> scalar, not marked
    ``chain_batched``) gives the same step as the chain-batched form."""
    y = torch.randn((C, B), generator=torch.Generator().manual_seed(0))

    def one_chain(p, batch):
        return -0.5 * ((batch[0] - p["mu"]) ** 2).sum() - 0.5 * p["mu"] ** 2

    def all_chains(p, batch):
        return -0.5 * ((batch[0] - p["mu"][:, None]) ** 2).sum(dim=1) - 0.5 * p["mu"] ** 2

    all_chains.chain_batched = True
    state = sgmcmc.sghmc_init({"mu": torch.tensor([0.0, 1.0, -2.0])})
    outs = []
    for fn in (one_chain, all_chains):
        kernel = sgmcmc.build_sghmc_kernel(fn, num_leapfrog=2)
        draws = kernel.draw(state, (y,), torch.Generator().manual_seed(1))
        outs.append(kernel(state, (y,), 1e-2, draws=draws)[0])
    for a, b in zip(outs[0], outs[1]):
        a, b = (a["mu"], b["mu"]) if isinstance(a, dict) else (a, b)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_schedules_match():
    for t in (0.0, 1.0, 10.0, 2500.0):
        tt = torch.tensor(t)
        for js, ts in ((jsg.inverse_time_decay(0.1), sgmcmc.inverse_time_decay(0.1)),
                       (jsg.inverse_time_decay(0.05, 0.3), sgmcmc.inverse_time_decay(0.05, 0.3)),
                       (jsg.constant_schedule(3e-4), sgmcmc.constant_schedule(3e-4)),
                       (jsg.polynomial_decay(0.01, 10.0), sgmcmc.polynomial_decay(0.01, 10.0)),
                       (jsg.polynomial_decay(0.5, 2.0, 0.7),
                        sgmcmc.polynomial_decay(0.5, 2.0, 0.7))):
            np.testing.assert_allclose(float(ts(tt)), float(js(jnp.float32(t))), rtol=1e-6)
    const = sgmcmc.constant_schedule(1e-3)
    assert const(torch.tensor(0.0)) is const(torch.tensor(5.0))     # no fill per step


@pytest.mark.parametrize("num_steps, burnin, collect_every", [
    (12, 0, 1), (12, 4, 2), (13, 4, 3), (10, 10, 2), (7, 0, 10)])
def test_run_loop_draw_count_and_step_counter(num_steps, burnin, collect_every):
    """T = (num_steps - burnin) // collect_every kept draws, and t keeps
    running through the burn-in: with eps_t = 1 / (1 + t) the kept step sizes
    are those of steps burnin + collect_every * (i + 1) - 1.  (With T = 0 the
    JAX loop still returns one draw, a quirk of its key split; the port
    returns none.)"""
    seen = []

    def kernel(state, batch, step_size, *, draws=None, generator=None):
        seen.append(batch[0].shape)
        value = torch.zeros(2)
        return sgmcmc.SGLDState(state.position, value), sgmcmc.SGMCMCInfo(value, step_size)

    state = sgmcmc.sgld_init({"q": torch.zeros(2, 3)})
    data = (torch.arange(50.0).reshape(25, 2),)
    _, positions, infos = sgmcmc.run_sgmcmc_chains(
        kernel, state, 2, data, batch_size=5, num_steps=num_steps,
        step_size_schedule=sgmcmc.inverse_time_decay(1.0, 1.0), collect_every=collect_every,
        burnin_steps=burnin, generator=torch.Generator().manual_seed(0))
    total = max((num_steps - burnin) // collect_every, 0)
    assert positions["q"].shape == (2, total, 3)
    assert infos.logdensity.shape == infos.step_size.shape == (2, total)
    assert len(seen) == burnin + total * collect_every and set(seen) <= {(2, 5, 2)}
    kept_t = burnin + collect_every * (np.arange(total) + 1) - 1
    np.testing.assert_allclose(infos.step_size[0].numpy(), 1.0 / (1.0 + kept_t), rtol=1e-6)
    if total:
        jtotal = jsg.run_sgmcmc(
            lambda k, s, b, e: (s, jsg.SGMCMCInfo(jnp.float32(0.0), jnp.asarray(e))),
            jsg.sgld_init({"q": jnp.zeros(3)}), jax.random.key(0), (jnp.zeros((25, 2)),),
            batch_size=5, num_steps=num_steps, step_size_schedule=jsg.inverse_time_decay(1., 1.),
            collect_every=collect_every, burnin_steps=burnin)[2].step_size
        np.testing.assert_allclose(infos.step_size[0].numpy(), np.asarray(jtotal), rtol=1e-6)


def test_run_loop_replays_the_jax_run():
    """``run_sgmcmc_chains`` with every step's draws replayed from the JAX
    loop's key splits (run_sgmcmc_chains: one key per chain; run_sgmcmc:
    (burn, sample) keys, one key per kept draw split into collect_every step
    keys, each split into (batch, kernel) keys): the kept positions of the
    keyed SGLD run agree over 7 steps, rtol 1e-4 (atol 1e-5)."""
    jm, tm, X, y, _, params = _problem()
    burnin, every, steps = 1, 2, 7
    jkernel = jsg.build_sgld_kernel(jm.make_batched_logdensity(N, dropout=True), keyed=True)
    tkernel = sgmcmc.build_sgld_kernel(tm.make_batched_logdensity(N, dropout=True), keyed=True)
    key = jax.random.key(3)
    sched = dict(batch_size=B, num_steps=steps, collect_every=every, burnin_steps=burnin)
    _, jpos, jinfo = jsg.run_sgmcmc_chains(
        jkernel, jax.vmap(jsg.sgld_init)(params), key, C, (jnp.asarray(X), jnp.asarray(y)),
        step_size_schedule=jsg.inverse_time_decay(1e-4, 0.5), **sched)

    def step_keys(chain_key):
        k_burn, k_sample = jax.random.split(chain_key)
        keys = list(jax.random.split(k_burn, burnin))
        for k in jax.random.split(k_sample, (steps - burnin) // every):
            keys += list(jax.random.split(k, every))
        return keys

    per_chain = [step_keys(k) for k in jax.random.split(key, C)]
    one = {k: v[0] for k, v in params.items()}      # shapes only

    def replayed():
        for s in range(len(per_chain[0])):
            split = [jax.random.split(per_chain[c][s]) for c in range(C)]
            idx = np.stack([np.array(jax.random.randint(kb, (B,), 0, N)) for kb, _ in split])
            per = [sgld_replay(ks, one, True) for _, ks in split]
            yield _draws([(r[0], None, r[1]) for r in per], torch.from_numpy(idx).long())

    _, tpos, tinfo = sgmcmc.run_sgmcmc_chains(
        tkernel, sgmcmc.sgld_init(params_from_jax(params, "cpu")), C,
        (torch.from_numpy(X), torch.from_numpy(y)),
        step_size_schedule=sgmcmc.inverse_time_decay(1e-4, 0.5), draws=replayed(), **sched)
    for k in jpos:
        assert tpos[k].shape == jpos[k].shape
        np.testing.assert_allclose(tpos[k].numpy(), np.asarray(jpos[k]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tinfo.logdensity.numpy(), np.asarray(jinfo.logdensity), rtol=1e-4)
    np.testing.assert_allclose(tinfo.step_size.numpy(), np.asarray(jinfo.step_size), rtol=1e-6)


# ---- statistical: the JAX package's tests/test_sgmcmc.py on the port --------


def _conjugate_gaussian():
    """Posterior of a mean mu with sigma = 1, prior N(0, 1), data y_i ~
    N(2, 1): N(n ybar / (n + 1), 1 / (n + 1))."""
    n = 256
    y = 2.0 + torch.randn((n,), generator=torch.Generator().manual_seed(0))

    def logdensity(params, batch):
        mu, (yb,) = params["mu"], batch
        ll = -0.5 * ((yb - mu[:, None]) ** 2).sum(dim=1) * (n / yb.shape[1])
        return ll - 0.5 * mu ** 2

    logdensity.chain_batched = True
    return (y,), logdensity, n * float(y.mean()) / (n + 1), 1.0 / (n + 1)


def test_sgld_posterior_mean():
    data, logdensity, post_mean, post_var = _conjugate_gaussian()
    _, positions, _ = sgmcmc.run_sgmcmc(
        sgmcmc.build_sgld_kernel(logdensity), sgmcmc.sgld_init({"mu": torch.zeros(1)}), data,
        batch_size=32, num_steps=4000, step_size_schedule=sgmcmc.constant_schedule(5e-4),
        collect_every=2, burnin_steps=1000, generator=torch.Generator().manual_seed(1))
    mus = positions["mu"].numpy()
    assert mus.shape == (1, 1500)
    assert abs(mus.mean() - post_mean) < 0.15, (mus.mean(), post_mean)
    assert mus.std() < 10 * np.sqrt(post_var) + 0.2


def test_sghmc_posterior_mean():
    data, logdensity, post_mean, _ = _conjugate_gaussian()
    kernel = sgmcmc.build_sghmc_kernel(logdensity, friction=1.0, num_leapfrog=1)
    _, positions, _ = sgmcmc.run_sgmcmc(
        kernel, sgmcmc.sghmc_init({"mu": torch.zeros(1)}), data, batch_size=32,
        num_steps=6000, step_size_schedule=sgmcmc.constant_schedule(1e-3), collect_every=2,
        burnin_steps=3000, generator=torch.Generator().manual_seed(2))
    mus = positions["mu"].numpy()
    assert abs(mus.mean() - post_mean) < 0.25, (mus.mean(), post_mean)


def _mlp_run(kernel_of, steps, every, seed=11, chains=2):
    _, tm, X, y, yi, params = _problem()
    data = (torch.from_numpy(X), torch.from_numpy(y))
    start = {k: torch.from_numpy(v[:chains]) for k, v in params.items()}
    kernel, init = kernel_of(tm)
    _, positions, infos = sgmcmc.run_sgmcmc_chains(
        kernel, init(start), chains, data, batch_size=64, num_steps=steps,
        step_size_schedule=sgmcmc.constant_schedule(1e-4), collect_every=every, burnin_steps=0,
        generator=torch.Generator().manual_seed(seed))
    return tm, data, yi, start, positions, infos


def _sgld(dropout):
    def kernel_of(tm):
        ld = tm.make_batched_logdensity(N, dropout=dropout)
        return sgmcmc.build_sgld_kernel(ld, keyed=dropout), sgmcmc.sgld_init
    return kernel_of


def test_dropout_potential_is_deterministic_per_seed_and_differs_from_no_dropout():
    """The keyed-mask property: the same generator seed reproduces the draws
    bit for bit (masks are a function of the stream, per chain and step),
    another seed does not, chains differ from each other, and the dropout
    potential samples something else than the deterministic one."""
    a = _mlp_run(_sgld(True), 60, 5)[4]
    b = _mlp_run(_sgld(True), 60, 5)[4]
    other = _mlp_run(_sgld(True), 60, 5, seed=12)[4]
    plain = _mlp_run(_sgld(False), 60, 5)[4]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["W1"], other["W1"])
    assert not torch.equal(a["W1"][0], a["W1"][1])
    assert max(float((a[k] - plain[k]).abs().max()) for k in a) > 1e-4


def test_sghmc_dropout_runs_and_improves():
    def kernel_of(tm):
        ld = tm.make_batched_logdensity(N, dropout=True)
        return (sgmcmc.build_sghmc_kernel(ld, friction=1.0, num_leapfrog=2, keyed=True),
                sgmcmc.sghmc_init)

    tm, (X, _), yi, start, positions, infos = _mlp_run(kernel_of, 1200, 10)
    assert bool(torch.isfinite(infos.logdensity).all())
    pm = {k: v[:, 40:].mean(dim=(0, 1)) for k, v in positions.items()}
    acc = float((tm.predict(pm, X).numpy() == yi).mean())
    acc0 = float((tm.predict({k: v[0] for k, v in start.items()}, X).numpy() == yi).mean())
    assert acc > max(acc0, 0.5), (acc0, acc)


def test_softmax_sgld_runs_and_improves():
    """SGLD on the softmax model, whose log density takes the per-chain
    minibatches the run loop gathers."""
    _, _, X, y, yi, _ = _problem()
    model = Softmax(dim=D, n_classes=K, alpha=1.0)
    g = torch.Generator().manual_seed(0)
    params0 = model.init_params(g, "cpu")
    _, positions, _ = sgmcmc.run_sgmcmc(
        sgmcmc.build_sgld_kernel(model.make_batched_logdensity(N)),
        sgmcmc.sgld_init({k: v[None] for k, v in params0.items()}),
        (torch.from_numpy(X), torch.from_numpy(y)), batch_size=64, num_steps=1500,
        step_size_schedule=sgmcmc.constant_schedule(1e-4), collect_every=10, burnin_steps=500,
        generator=g)
    pm = {k: v.mean(dim=(0, 1)) for k, v in positions.items()}
    acc = float((model.predict(pm, torch.from_numpy(X)).numpy() == yi).mean())
    acc0 = float((model.predict(params0, torch.from_numpy(X)).numpy() == yi).mean())
    assert acc > max(acc0, 0.6), (acc0, acc)


def test_keyed_needs_a_mask_source():
    with pytest.raises(ValueError, match="draw_masks"):
        sgmcmc.build_sgld_kernel(lambda p, b, m: p["x"].sum(), keyed=True)
