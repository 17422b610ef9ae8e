"""The port's per-chain sampling entry points, against the JAX package's.

Whole runs are compared statistically (the two packages' random streams
differ): posterior moments against the analytic target (mean 0.1, covariance
0.15) or between the packages, acceptance within 0.05, adapted step sizes
within a factor 1.3, ESS per draw within a factor 1.5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu import diagnostics as jdiag  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu import models as jmodels  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference import hmc as jhmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference import sampling as jsampling  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.io import datasets as jdatasets  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import models  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.parallel import RankLayout  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics import summarize  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc, nuts  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import sampling  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.base import (  # noqa: E402
    posterior_dict,
    run_inference,
)
from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets  # noqa: E402

COV = np.array([[1.5, 0.5], [0.5, 1.5]], np.float32)   # the mvn-hmc target


@pytest.fixture
def one_thread():
    """Thousands of tiny ops: one intra-op thread is as fast alone and does
    not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_run(model, logdensity, chains, samples, warmup, jitter, seed):
    kernel = jhmc.build_kernel(logdensity, 16)
    key = jax.random.key(seed)
    positions = jsampling.init_chain_positions(model.init_params, key, chains, jitter=jitter)
    post = jax.jit(lambda p, k: jsampling.sample_posterior(
        lambda q: jhmc.init(q, logdensity), kernel, p, k, num_samples=samples,
        num_warmup=warmup, num_chains=chains))(positions, key)
    agg = jdiag.summarize(post.positions)["aggregate"]
    return post, float(agg["min_ess"]), float(agg["max_rhat"])


def _torch_run(model, logdensity, chains, samples, warmup, jitter, seed):
    gen = torch.Generator().manual_seed(seed)
    positions = sampling.init_chain_positions(model.init_params, chains, jitter=jitter,
                                              generator=gen, device="cpu")
    post = sampling.sample_posterior(lambda q: hmc.init(q, logdensity),
                                     hmc.build_kernel(logdensity, 16), positions,
                                     num_samples=samples, num_warmup=warmup, num_chains=chains,
                                     generator=gen)
    agg = summarize(post.positions)["aggregate"]
    return post, float(agg["min_ess"]), float(agg["max_rhat"])


def _compare_runs(jrun, trun, draws_total):
    (jpost, jess, jrhat), (tpost, tess, trhat) = jrun, trun
    jacc = float(jnp.mean(jpost.infos.acceptance_prob))
    tacc = float(tpost.infos.acceptance_prob.mean())
    assert abs(tacc - jacc) < 0.05, (tacc, jacc)
    ratio = float(tpost.step_size.median()) / float(jnp.median(jpost.step_size))
    assert 1 / 1.3 < ratio < 1.3, ratio
    assert 1 / 1.5 < (tess / draws_total) / (jess / draws_total) < 1.5, (tess, jess)
    assert trhat < 1.01 and jrhat < 1.01
    assert not bool(tpost.infos.is_divergent.any())
    # jittered lengths: every chain draws its own, 1..16 leapfrog steps
    n = tpost.infos.num_integration_steps
    assert int(n.min()) >= 1 and int(n.max()) == 16
    assert abs(float(n.float().mean()) - float(jnp.mean(jpost.infos.num_integration_steps))) < 0.5


def test_mvn_statistical_parity(one_thread):
    """Config 1 (4 x 1000, HMC, L = 16, window warmup with mass adaptation)."""
    chains, samples = 4, 1000
    jrun = _jax_run(jmodels.MVNGaussian(jnp.zeros(2), jnp.asarray(COV)),
                    jmodels.MVNGaussian(jnp.zeros(2), jnp.asarray(COV)).make_logdensity(),
                    chains, samples, 300, 1.0, 0)
    tmodel = models.MVNGaussian(np.zeros(2, np.float32), COV)
    trun = _torch_run(tmodel, tmodel.make_logdensity(), chains, samples, 300, 1.0, 0)
    _compare_runs(jrun, trun, chains * samples)
    tpost = trun[0]
    assert tpost.positions["x"].shape == (chains, samples, 2)
    assert tpost.infos.acceptance_prob.shape == (chains, samples)
    flat = tpost.positions["x"].reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.15)
    assert trun[1] > 2000 and 0.6 < float(tpost.infos.acceptance_prob.mean()) < 0.99
    # per-chain adaptation: the chains end with different steps and masses
    assert len(tpost.step_size.unique()) == chains
    assert tpost.inv_mass["x"].shape == (chains, 2) and bool((tpost.inv_mass["x"] != 1).all())


def test_logistic_blobs_statistical_parity(one_thread):
    """Config 2 at 16 chains x 500: both packages on the same blobs."""
    chains, samples = 16, 500
    (Xtr, ytr), (Xte, yte) = datasets.blobs(n=1000)
    jm = jmodels.Logistic(dim=2, alpha=0.1)
    (jXtr, jytr), _ = jdatasets.blobs(n=1000)
    jrun = _jax_run(jm, jm.make_logdensity(batch=(jXtr, jytr)), chains, samples, 300, 0.5, 1)
    tm = models.Logistic(dim=2, alpha=0.1)
    batch = (torch.from_numpy(Xtr), torch.from_numpy(ytr))
    trun = _torch_run(tm, tm.make_logdensity(batch=batch), chains, samples, 300, 0.5, 1)
    _compare_runs(jrun, trun, chains * samples)
    jpost, tpost = jrun[0], trun[0]
    for k in ("weights", "bias"):
        jd = np.asarray(jpost.positions[k]).reshape(chains * samples, -1)
        td = tpost.positions[k].reshape(chains * samples, -1).numpy()
        sd = jd.std(axis=0)
        np.testing.assert_allclose(td.mean(axis=0), jd.mean(axis=0), atol=float(0.15 * sd.max()))
        np.testing.assert_allclose(td.std(axis=0), sd, rtol=0.15)
    pm = {k: v.mean(dim=(0, 1)) for k, v in tpost.positions.items()}
    acc = float((tm.predict(pm, torch.from_numpy(Xte)) == torch.from_numpy(yte)).float().mean())
    assert acc >= 0.98


def _mvn_setup(chains, seed):
    model = models.MVNGaussian(np.zeros(2, np.float32), COV)
    ld = model.make_logdensity()
    gen = torch.Generator().manual_seed(seed)
    pos = sampling.init_chain_positions(model.init_params, chains, jitter=1.0, generator=gen,
                                        device="cpu")
    return ld, pos, gen


def test_run_inference_thinning_and_posterior_dict():
    """thin = 3 keeps every third state of the same chain of draws."""
    ld, pos, _ = _mvn_setup(3, 0)
    kernel = hmc.build_kernel(ld, 4)
    eps, ones = torch.full((3,), 0.4), {"x": torch.ones(3, 2)}

    def fixed(state, generator):
        return kernel(state, eps, ones, generator=generator)

    state = hmc.init(pos, ld)
    final1, (states1, infos1) = run_inference(fixed, state, 12,
                                              generator=torch.Generator().manual_seed(5))
    final3, (states3, infos3) = run_inference(fixed, state, 4, thin=3,
                                              generator=torch.Generator().manual_seed(5))
    assert posterior_dict(states1)["x"].shape == (12, 3, 2)
    assert infos3.acceptance_prob.shape == (4, 3)
    assert torch.equal(posterior_dict(states3)["x"], posterior_dict(states1)["x"][2::3])
    assert torch.equal(final3.position["x"], final1.position["x"])


def test_init_chain_positions_and_stack_chains():
    model = models.Logistic(dim=3)
    gen = torch.Generator().manual_seed(0)
    plain = sampling.init_chain_positions(model.init_params, 5, generator=gen, device="cpu")
    assert plain["weights"].shape == (5, 3) and plain["bias"].shape == (5,)
    assert len(plain["weights"][:, 0].unique()) == 5 and bool((plain["bias"] == 0).all())
    jit = sampling.init_chain_positions(model.init_params, 500, jitter=0.5, generator=gen,
                                        device="cpu")
    assert abs(float(jit["bias"].std()) - 0.5) < 0.06
    tiled = sampling.stack_chains({"w": torch.arange(3.0), "b": torch.tensor(2.0)}, 4)
    assert tiled["w"].shape == (4, 3) and tiled["b"].shape == (4,)
    assert bool((tiled["w"] == torch.arange(3.0)).all())


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_streaming_gives_the_draws_of_sample_posterior(sampler):
    """The chunked form gives the draws of ``sample_posterior``'s own pieces
    (``run_warmup``, then the kernel at the adapted step) run on the chunk
    streams: warmup on the generator of (seed, warmup stream), chunk i on
    that of (seed, sample stream, i).  The generator it is handed gives the
    seed and is not drawn from."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference.warmup import run_warmup
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams

    ld, pos, _ = _mvn_setup(3, 1)
    if sampler == "hmc":
        kernel, init_fn = hmc.build_kernel(ld, 5), lambda q: hmc.init(q, ld)
    else:
        kernel, init_fn = nuts.build_kernel(ld, max_tree_depth=4), lambda q: nuts.init(q, ld)
    gen = torch.Generator().manual_seed(2)
    state_before = gen.get_state()
    backend = sampling.DeviceBackend(num_draws=25)
    states, step, inv_mass, appended = sampling.sample_posterior_streaming(
        init_fn, kernel, pos, backend, num_samples=25, chunk_size=10, num_warmup=40,
        num_chains=3, generator=gen)
    assert appended == 25 and backend.num_draws() == 25
    assert torch.equal(gen.get_state(), state_before)

    warm = run_warmup(kernel, init_fn(pos), 40, initial_step_size=torch.full((3,), 0.1),
                      generator=streams.chunk_generator(2, streams.STREAM_WARMUP, 0, "cpu"))
    state, xs = warm.state, []
    for i, take in enumerate([10, 10, 5]):
        g = streams.chunk_generator(2, streams.STREAM_SAMPLE, i, "cpu")
        for _ in range(take):
            state, _ = kernel(state, warm.step_size, warm.inv_mass, generator=g)
            xs.append(state.position["x"])
    assert torch.equal(backend.draws()["x"], torch.stack(xs, dim=1))
    assert torch.equal(step, warm.step_size)
    assert torch.equal(states.position["x"], state.position["x"])


def test_sampling_functions_check_their_arguments():
    ld, pos, gen = _mvn_setup(3, 3)
    kernel, init_fn = hmc.build_kernel(ld, 2), lambda q: hmc.init(q, ld)
    with pytest.raises(ValueError, match="3 chains"):
        sampling.sample_posterior(init_fn, kernel, pos, num_samples=2, num_chains=4,
                                  generator=gen)
    # no warmup: the initial step size for every chain, unit mass
    post = sampling.sample_posterior(init_fn, kernel, pos, num_samples=3, num_warmup=0,
                                     num_chains=3, initial_step_size=0.25, generator=gen)
    assert bool((post.step_size == 0.25).all()) and bool((post.inv_mass["x"] == 1).all())
    with pytest.raises(ValueError, match="3 chains"):
        sampling.sample_posterior_streaming(init_fn, kernel, pos, sampling.DeviceBackend(),
                                            num_samples=2, num_chains=4, generator=gen)
    # chain sharding: the generator must carry the rank's chain block
    state = hmc.init(pos, ld)
    with pytest.raises(ValueError, match="chain block"):
        sampling.sample_batched_streaming(kernel, state, torch.full((3,), 0.25),
                                          {"x": torch.ones(3, 2)}, sampling.DeviceBackend(),
                                          num_samples=2, mesh=RankLayout(2, 1, 0),
                                          generator=gen)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        sampling.sample_batched_streaming(kernel, state, torch.full((3,), 0.25),
                                          {"x": torch.ones(3, 2)}, sampling.DeviceBackend(),
                                          num_samples=2, generator=None)
