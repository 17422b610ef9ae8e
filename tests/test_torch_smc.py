"""Parity of the port's adaptive tempered SMC with the JAX package, on the
CPU in f32.

``systematic_resample`` with the JAX offset ``u0`` injected gives the same
parent indices; ``ess_from_log_weights`` agrees within rtol 1e-6;
``_solve_next_lambda`` within rtol 1e-5 (thirty float32 bisection steps: an
ESS within an ulp of its target may fall on either side).  One full stage is
replayed: the JAX stage splits its key three ways (resample, mutate, next),
the mutation key into one key per round and that into one per particle,
which the HMC kernel splits into (momentum, jitter, accept) keys; all of it
goes into the port as one ``SMCDraws``, and the particles, the evidence, the
stage's lambda, ESS, acceptance and step size agree within rtol 1e-4 (atol
1e-5).  The statistical tests are the JAX package's own (tests/test_smc.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import hmc as jhmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference import smc as jsmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.tree import (  # noqa: E402
    tree_randn_like as jax_randn_like,
)
from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc, smc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.sgmcmc import SGMCMCDraws  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Loops of thousands of tiny ops: one intra-op thread is as fast alone
    and does not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_matches_with_injected_offset(seed):
    n = 257
    log_w = (3.0 * np.random.RandomState(seed).randn(n)).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jsmc.systematic_resample(key, jnp.asarray(log_w)))
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)
    got = smc.systematic_resample(torch.from_numpy(log_w), u0=_t(u0))
    np.testing.assert_array_equal(got.numpy(), np.minimum(want, n - 1))
    assert got.dtype == torch.int64 and int(got.max()) <= n - 1


def test_systematic_resample_properties():
    g = torch.Generator().manual_seed(0)
    idx = smc.systematic_resample(torch.zeros(1000), generator=g)
    counts = np.bincount(idx.numpy(), minlength=1000)
    assert counts.max() == 1 and counts.min() == 1      # uniform weights: every parent once
    log_w = torch.cat([torch.zeros(10), torch.full((90,), -100.0)])
    assert bool((smc.systematic_resample(log_w, generator=g) < 10).all())
    # cum[-1] < 1 in float32 with the largest offset: the index still clips to n - 1
    top = smc.systematic_resample(torch.zeros(3), u0=torch.tensor(1.0 / 3 - 1e-8))
    assert int(top.max()) <= 2
    with pytest.raises(ValueError, match="u0= or an explicit generator="):
        smc.systematic_resample(torch.zeros(4))


@pytest.mark.parametrize("seed, lmbda, target", [(0, 0.0, 0.5), (1, 0.2, 0.7), (2, 0.0, 0.9),
                                                 (3, 0.6, 0.5)])
def test_next_lambda_and_ess_match(seed, lmbda, target):
    rng = np.random.RandomState(seed)
    n = 200
    # spread small enough at seed 3 that the whole remaining step fits (lambda' = 1)
    loglik = ((0.5 if seed == 3 else 40.0) * rng.randn(n)).astype(np.float32)
    log_w = (0.1 * rng.randn(n)).astype(np.float32)
    np.testing.assert_allclose(float(smc.ess_from_log_weights(torch.from_numpy(loglik))),
                               float(jsmc.ess_from_log_weights(jnp.asarray(loglik))), rtol=1e-6)
    want = float(jsmc._solve_next_lambda(jnp.asarray(loglik), jnp.asarray(log_w),
                                         jnp.float32(lmbda), target))
    got = float(smc._solve_next_lambda(torch.from_numpy(loglik), torch.from_numpy(log_w),
                                       torch.tensor(lmbda), target))
    assert got == pytest.approx(want, rel=1e-5)
    assert lmbda < got <= 1.0 and (got == 1.0) == (seed == 3)


def _gaussian_problem(n_obs, dim, seed=0):
    y = (0.5 + 0.3 * np.random.RandomState(seed).randn(n_obs)).astype(np.float32)
    jy, ty = jnp.asarray(y), torch.from_numpy(y)

    def jprior(p):
        return -0.5 * jnp.sum(p["mu"] ** 2)

    def jlik(p):
        return jnp.sum(-0.5 * ((jy[:, None] - p["mu"]) / 0.3) ** 2)

    def tprior(p):
        return -0.5 * (p["mu"] ** 2).sum(dim=-1)

    def tlik(p):
        return (-0.5 * ((ty[:, None] - p["mu"][..., None, :]) / 0.3) ** 2).sum(dim=(-2, -1))

    tprior.chain_batched = tlik.chain_batched = True
    return y, (jprior, jlik), (tprior, tlik)


def test_one_hmc_stage_matches_jax_with_replayed_draws():
    n, dim, rounds, L = 64, 3, 2, 4
    _, (jprior, jlik), (tprior, tlik) = _gaussian_problem(200, dim)
    particles = {"mu": np.random.RandomState(1).randn(n, dim).astype(np.float32)}
    key = jax.random.key(5)
    kw = dict(step_size=0.05, num_mcmc_steps=rounds, target_ess=0.6, max_stages=1)
    jstate, jinfo = jsmc.run_tempered_smc(
        key, particles, jprior, jlik,
        kernel_builder=lambda ld: jhmc.build_kernel(ld, L),
        init_builder=lambda ld: (lambda p: jhmc.init(p, ld)), **kw)

    k_res, k_mut, _ = jax.random.split(key, 3)
    u0 = jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / n)
    replay = []
    for k in jax.random.split(k_mut, rounds):
        def one(kk):
            k_mom, k_steps, k_accept = jax.random.split(kk, 3)
            return (jax_randn_like(k_mom, {"mu": jnp.zeros(dim)}), jax.random.uniform(k_steps),
                    jax.random.uniform(k_accept))
        mom, u_steps, u_accept = jax.vmap(one)(jax.random.split(k, n))
        replay.append({"momentum": {"mu": _t(mom["mu"])}, "jitter_uniforms": _t(u_steps),
                       "uniforms": _t(u_accept)})
    tstate, tinfo = smc.run_tempered_smc(
        params_from_jax(particles, "cpu"), tprior, tlik,
        kernel_builder=lambda ld: hmc.build_kernel(ld, L),
        init_builder=lambda ld: (lambda p: hmc.init(p, ld)),
        draws=[smc.SMCDraws(_t(u0), replay)], **kw)

    close = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tstate.particles["mu"].numpy(),
                               np.asarray(jstate.particles["mu"]), **close)
    assert int(tinfo.num_stages) == int(jinfo.num_stages) == 1
    for field in ("lmbda", "log_evidence"):
        np.testing.assert_allclose(float(getattr(tstate, field)), float(getattr(jstate, field)),
                                   **close)
    assert 0.0 < float(tstate.lmbda) < 1.0
    np.testing.assert_array_equal(tstate.log_weights.numpy(), np.zeros(n, np.float32))
    for field in ("stage_lmbda", "stage_ess", "stage_acceptance", "stage_step_size", "ess",
                  "acceptance"):
        np.testing.assert_allclose(getattr(tinfo, field).numpy(),
                                   np.asarray(getattr(jinfo, field)), err_msg=field, **close)
    converted = params_from_jax(jstate, "cpu")
    assert isinstance(converted, smc.SMCState) and converted.log_weights.shape == (n,)


def test_one_sghmc_stage_matches_jax_with_replayed_draws():
    n, dim, rounds, B = 48, 2, 3, 16
    y, (jprior, jlik), (tprior, tlik) = _gaussian_problem(120, dim)

    def jlik_batch(p, b):
        return jnp.sum(-0.5 * ((b[0][:, None] - p["mu"]) / 0.3) ** 2)

    def tlik_batch(p, b):
        return (-0.5 * ((b[0][:, None] - p["mu"][..., None, :]) / 0.3) ** 2).sum(dim=(-2, -1))

    tlik_batch.chain_batched = True
    particles = {"mu": np.random.RandomState(2).randn(n, dim).astype(np.float32)}
    key = jax.random.key(8)
    kw = dict(mutation="sghmc", batch_size=B, step_size=1e-4, num_mcmc_steps=rounds,
              max_stages=1, sghmc_friction=2.0)
    jstate, jinfo = jsmc.run_tempered_smc(key, particles, jprior, jlik,
                                          log_likelihood_batch_fn=jlik_batch,
                                          data=(jnp.asarray(y),), **kw)
    k_res, k_mut, _ = jax.random.split(key, 3)
    u0 = jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / n)
    replay = []
    for k in jax.random.split(k_mut, rounds):
        k_batch, k_step = jax.random.split(k)
        idx = jax.random.randint(k_batch, (B,), 0, y.shape[0])

        def one(kk):     # SGHMC, one inner step, not keyed: split -> (momentum, noise) keys
            _, k_noise = jax.random.split(kk)
            return jax_randn_like(jax.random.split(k_noise, 1)[0], {"mu": jnp.zeros(dim)})
        noise = jax.vmap(one)(jax.random.split(k_step, n))
        replay.append(SGMCMCDraws(indices=_t(idx).long(), noise=({"mu": _t(noise["mu"])},)))
    tstate, tinfo = smc.run_tempered_smc(
        params_from_jax(particles, "cpu"), tprior, tlik, log_likelihood_batch_fn=tlik_batch,
        data=(torch.from_numpy(y),), draws=[smc.SMCDraws(_t(u0), replay)], **kw)
    np.testing.assert_allclose(tstate.particles["mu"].numpy(),
                               np.asarray(jstate.particles["mu"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tstate.log_evidence), float(jstate.log_evidence), rtol=1e-4)
    assert bool(torch.isnan(tinfo.stage_acceptance).all())
    np.testing.assert_allclose(tinfo.stage_step_size[0].numpy(), 1e-4, rtol=1e-6)


# ---- statistical: the JAX package's tests/test_smc.py on the port ------------


def _hmc_mutation(num_steps=8):
    return dict(kernel_builder=lambda ld: hmc.build_kernel(ld, num_steps),
                init_builder=lambda ld: (lambda p: hmc.init(p, ld)))


def _stages(info, field):
    a = getattr(info, field).numpy()
    return a[~np.isnan(a)]


def test_smc_step_size_adaptation_holds_acceptance():
    """On a sharpening target (posterior sd ~30x smaller than the prior's) a
    fixed, deliberately too large step collapses the late-stage acceptance;
    the adaptive schedule keeps every stage in a healthy band and shrinks
    the step."""
    y, _, (tprior, tlik) = _gaussian_problem(1000, 4)
    g = torch.Generator().manual_seed(1)
    particles = {"mu": torch.randn((256, 4), generator=g)}

    def run(adapt):
        return smc.run_tempered_smc(particles, tprior, tlik, step_size=1.0, num_mcmc_steps=3,
                                    target_ess=0.7, adapt_step_size=adapt,
                                    generator=torch.Generator().manual_seed(2), **_hmc_mutation())

    state_a, info_a = run(True)
    _, info_f = run(False)
    acc_a, acc_f = _stages(info_a, "stage_acceptance"), _stages(info_f, "stage_acceptance")
    eps_a = _stages(info_a, "stage_step_size")
    assert float(state_a.lmbda) == 1.0
    assert acc_f.min() < 0.2, acc_f
    assert acc_a[1:].min() > 0.2, acc_a         # stage 0 pays the probe cost
    assert acc_a.max() <= 1.0
    assert eps_a[0] == 1.0 and eps_a[-1] < eps_a[0], eps_a
    assert len(eps_a) == int(info_a.num_stages) and np.isnan(info_a.stage_lmbda.numpy()[-1])
    post_mean = float(y.sum() / 0.09) / (len(y) / 0.09 + 1.0)
    assert np.abs(state_a.particles["mu"].numpy().mean(0) - post_mean).max() < 0.05


def test_tempered_smc_gaussian_posterior_and_evidence():
    """Prior N(0, 1), y ~ N(mu, 1): the posterior is N(n ybar / (n + 1),
    1 / (n + 1)) and the evidence is analytic.  One particle's log densities
    (not marked chain-batched) go through vmap."""
    n_obs = 64
    g = torch.Generator().manual_seed(0)
    y = 1.5 + torch.randn((n_obs,), generator=g)
    post_mean, post_var = n_obs * float(y.mean()) / (n_obs + 1), 1.0 / (n_obs + 1)
    c = 0.5 * np.log(2 * np.pi)

    def log_prior(p):
        return -0.5 * p["mu"] ** 2 - c

    def log_lik(p):
        return (-0.5 * (y - p["mu"]) ** 2 - c).sum()

    state, info = smc.run_tempered_smc(
        {"mu": torch.randn((512,), generator=g)}, log_prior, log_lik, step_size=0.2,
        num_mcmc_steps=5, target_ess=0.5, generator=g, **_hmc_mutation())
    assert float(state.lmbda) == 1.0 and int(info.num_stages) >= 1
    mus = state.particles["mu"].numpy()
    assert abs(mus.mean() - post_mean) < 0.1, (mus.mean(), post_mean)
    assert abs(mus.std() - np.sqrt(post_var)) < 0.1
    yv = y.double().numpy()
    sigma = np.eye(n_obs) + np.ones((n_obs, n_obs))
    lz = (-0.5 * n_obs * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(sigma)[1]
          - 0.5 * yv @ np.linalg.solve(sigma, yv))
    assert abs(float(state.log_evidence) - lz) < 2.0, (float(state.log_evidence), lz)


def test_tempered_smc_sghmc_mutation():
    n_obs = 256
    g = torch.Generator().manual_seed(0)
    y = 1.5 + torch.randn((n_obs,), generator=g)
    post_mean, post_var = n_obs * float(y.mean()) / (n_obs + 1), 1.0 / (n_obs + 1)

    def log_prior(p):
        return -0.5 * p["mu"] ** 2

    def log_lik(p):
        return (-0.5 * (y - p["mu"]) ** 2).sum()

    def log_lik_batch(p, batch):
        return (-0.5 * (batch[0] - p["mu"]) ** 2).sum()

    state, info = smc.run_tempered_smc(
        {"mu": torch.randn((512,), generator=g)}, log_prior, log_lik, mutation="sghmc",
        log_likelihood_batch_fn=log_lik_batch, data=(y,), batch_size=64, step_size=2e-3,
        num_mcmc_steps=10, generator=g)
    assert float(state.lmbda) == 1.0
    mus = state.particles["mu"].numpy()
    assert abs(mus.mean() - post_mean) < 0.15, (mus.mean(), post_mean)
    assert abs(mus.std() - np.sqrt(post_var)) < 0.15
    assert np.isnan(info.stage_acceptance.numpy()[: int(info.num_stages)]).all()


def test_bad_arguments_raise():
    p = {"mu": torch.zeros(4)}
    fn = lambda q: q["mu"]    # noqa: E731
    with pytest.raises(ValueError, match="unknown mutation"):
        smc.run_tempered_smc(p, fn, fn, mutation="nuts")
    with pytest.raises(ValueError, match="requires kernel_builder and init_builder"):
        smc.run_tempered_smc(p, fn, fn)
    with pytest.raises(ValueError, match="sghmc mutation needs"):
        smc.run_tempered_smc(p, fn, fn, mutation="sghmc")
