"""The port's random streams (ops/streams.py): chunk generators mixed from
(seed, tag, index), and chain blocks.

A generator that carries ``ChainBlock(C, c0, c1)`` must give every draw site
the rows [c0, c1) of what the plain generator of the same seed gives it, bit
for bit, and a block run of a sampler the rows of the full run.  The samplers'
rows are compared bit for bit where the model computes each chain's values
from that chain's rows alone in an order that does not depend on the batch
(elementwise work and per-row reductions); the MVN target's batched product
``x @ P`` may be blocked differently for 2 rows than for 5, so there the
tolerance is rtol 1e-6, stated at the assertion.  Without a block every site
draws what it drew before the streams existed: a few values are pinned from
the commit before.  Imports no jax.
"""

import numpy as np
import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch import models
from dropout_hamiltonian_montecarlo_tpu_torch.inference import (hmc, metropolis, nuts_batched,
                                                                sampling, sgmcmc)
from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams
from dropout_hamiltonian_montecarlo_tpu_torch.ops.kron_metric import (
    KronMetric, class_fisher_eigh, gram_eigh_augmented, make_whitened_gauge_gibbs)
from dropout_hamiltonian_montecarlo_tpu_torch.ops.streams import ChainBlock
from dropout_hamiltonian_montecarlo_tpu_torch.ops.tree import (tree_batch_randn_like,
                                                              tree_randn_like)

C, BLOCK = 5, ChainBlock(5, 1, 3)
COV = np.array([[1.5, 0.5], [0.5, 1.5]], np.float32)


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of tiny ops: one intra-op thread is as fast alone and does
    not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gens(seed=7, block=BLOCK):
    return torch.Generator().manual_seed(seed), streams.block_generator(seed, "cpu", block)


def _rows(t, axis=0, block=BLOCK):
    return t.narrow(axis, block.start, block.size)


def test_splitmix64_and_mix_seed():
    # the first output of the reference SplitMix64 generator seeded with 0
    assert streams._splitmix64(0) == 0xE220A8397B1DCDAF
    seeds = {streams.mix_seed(s, t, i) for s in (0, 1, 2) for t in (1, 2, 3) for i in range(50)}
    assert len(seeds) == 450 and all(0 <= s < 2 ** 63 for s in seeds)
    assert streams.mix_seed(3, 2, 5) == streams.mix_seed(3, 2, 5)


def test_chunk_generator_depends_on_seed_tag_index_only():
    g = torch.Generator().manual_seed(9)
    a = streams.derive(g, streams.STREAM_SAMPLE, 4)
    torch.randn(100, generator=g)                      # the parent's state is never read
    b = streams.derive(g, streams.STREAM_SAMPLE, 4)
    c = streams.chunk_generator(9, streams.STREAM_SAMPLE, 4, "cpu")
    x = torch.randn(8, generator=a)
    assert torch.equal(x, torch.randn(8, generator=b))
    assert torch.equal(x, torch.randn(8, generator=c))
    for other in (streams.derive(g, streams.STREAM_SAMPLE, 5),
                  streams.derive(g, streams.STREAM_WARMUP, 4),
                  streams.chunk_generator(10, streams.STREAM_SAMPLE, 4, "cpu")):
        assert not torch.equal(x, torch.randn(8, generator=other))
    # a block rides along
    blocked = streams.derive(streams.block_generator(9, "cpu", BLOCK), streams.STREAM_SAMPLE, 4)
    assert streams.block_of(blocked) == BLOCK and streams.block_of(a) is None
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        streams.derive(None, streams.STREAM_SAMPLE)


@pytest.mark.parametrize("helper", ["randn", "rand", "randint", "keep_mask"])
@pytest.mark.parametrize("shape, axis", [((C, 4), 0), ((3, C), 1), ((2, 3, C), 2), ((C,), 0)],
                         ids=["axis0", "axis1", "axis2", "vector"])
def test_helper_draws_the_rows_of_the_full_draw(helper, shape, axis):
    full_gen, block_gen = _gens()
    local = list(shape)
    local[axis] = BLOCK.size
    kw = dict(device="cpu", chain_axis=axis)

    def draw(gen, s):
        if helper == "randint":
            return streams.randint(0, 1000, s, generator=gen, **kw)
        if helper == "keep_mask":
            return streams.keep_mask(s, 0.6, generator=gen, **kw)
        return getattr(streams, helper)(s, generator=gen, **kw)

    for _ in range(3):      # the generators advance alike
        full, part = draw(full_gen, shape), draw(block_gen, tuple(local))
        assert part.shape == tuple(local)
        assert torch.equal(part, _rows(full, axis))


def test_helpers_check_their_arguments():
    _, block_gen = _gens()
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        streams.randn((2, 3), generator=None, device="cpu")
    with pytest.raises(ValueError, match="4 chains on axis 0"):
        streams.randn((4, 3), generator=block_gen, device="cpu")
    with pytest.raises(ValueError, match="not a block"):
        streams.block_generator(0, "cpu", ChainBlock(4, 3, 3))
    # a draw without a chain axis is the same on every block
    full_gen, block_gen = _gens()
    assert torch.equal(streams.rand((6,), generator=block_gen, device="cpu", chain_axis=None),
                       streams.rand((6,), generator=full_gen, device="cpu", chain_axis=None))


def _kron(d=6, k=4, n=40, seed=0):
    rng = np.random.RandomState(seed)
    X = torch.from_numpy(rng.rand(n, d).astype(np.float32))
    metric = KronMetric(gram_eigh_augmented(X), class_fisher_eigh(k), 1.0, "cpu")
    qmap = {"weights": torch.from_numpy(0.1 * rng.randn(d, k).astype(np.float32)),
            "bias": torch.from_numpy(0.1 * rng.randn(k).astype(np.float32))}
    return metric, qmap


def test_draw_sites_draw_their_block():
    """Every site that draws over a chain axis, full against block."""
    like = {"w": torch.zeros(C, 2, 3), "b": torch.zeros(C, 3)}
    part_like = {k: _rows(v) for k, v in like.items()}
    for fn in (tree_randn_like, tree_batch_randn_like):
        full_gen, block_gen = _gens()
        full, part = fn(like, full_gen), fn(part_like, block_gen)
        assert all(torch.equal(part[k], _rows(full[k])) for k in like)

    full_gen, block_gen = _gens()
    full = nuts_batched.sample_draws(C, 4, 3, full_gen, "cpu")
    part = nuts_batched.sample_draws(BLOCK.size, 4, 3, block_gen, "cpu")
    assert torch.equal(part.momentum, _rows(full.momentum))
    for name in ("direction", "leaf_uniform", "bias_uniform"):
        assert torch.equal(getattr(part, name), _rows(getattr(full, name), -1)), name

    full_gen, block_gen = _gens()
    full = metropolis.sample_draws(C, 4, full_gen, "cpu")
    part = metropolis.sample_draws(BLOCK.size, 4, block_gen, "cpu")
    assert all(torch.equal(p, _rows(f)) for p, f in zip(part, full))

    mlp = models.DropoutMLP(dim=5, hidden=4, n_classes=3, p_drop=0.3)
    params = {"W1": torch.zeros(C, 5, 4)}
    X = torch.zeros(7, 5)
    full_gen, block_gen = _gens()
    full = mlp.draw_masks(params, X, full_gen)
    part = mlp.draw_masks({"W1": params["W1"][1:3]}, X, block_gen)
    assert all(torch.equal(p, _rows(f)) for p, f in zip(part, full))
    # a per-chain batch (C, B, D) gives the masks' chain axis
    full_gen, block_gen = _gens()
    full = mlp.draw_masks({"W1": torch.zeros(5, 4)}, torch.zeros(C, 7, 5), full_gen)
    part = mlp.draw_masks({"W1": torch.zeros(5, 4)}, torch.zeros(2, 7, 5), block_gen)
    assert all(torch.equal(p, _rows(f)) for p, f in zip(part, full))

    metric, _ = _kron()
    pos = {"weights": torch.zeros(C, 6, 4), "bias": torch.zeros(C, 4)}
    full_gen, block_gen = _gens()
    full = metric.sample_momentum(pos, full_gen)
    part = metric.sample_momentum({k: _rows(v) for k, v in pos.items()}, block_gen)
    # the draws are equal bit for bit; the two eigenbasis products behind them
    # are batched matmuls over 2 or 5 chains: rtol 1e-6
    for k in pos:
        torch.testing.assert_close(part[k], _rows(full[k]), rtol=1e-6, atol=1e-6)


def test_init_chain_positions_draws_its_block():
    model = models.Logistic(dim=3)
    full_gen, block_gen = _gens()
    full = sampling.init_chain_positions(model.init_params, C, jitter=0.5, generator=full_gen,
                                         device="cpu")
    part = sampling.init_chain_positions(model.init_params, BLOCK.size, jitter=0.5,
                                         generator=block_gen, device="cpu")
    assert all(torch.equal(part[k], _rows(full[k])) for k in full)
    with pytest.raises(ValueError, match="num_chains=3"):
        sampling.init_chain_positions(model.init_params, 3, generator=block_gen, device="cpu")


def _mvn():
    model = models.MVNGaussian(np.zeros(2, np.float32), COV)
    return model, model.make_logdensity()


def test_block_run_of_hmc_gives_the_full_runs_rows():
    model, ld = _mvn()
    kernel, init_fn = hmc.build_kernel(ld, 5), lambda q: hmc.init(q, ld)
    runs = []
    for gen, n in zip(_gens(3), (C, BLOCK.size)):
        pos = sampling.init_chain_positions(model.init_params, n, jitter=1.0, generator=gen,
                                            device="cpu")
        runs.append(sampling.sample_posterior(init_fn, kernel, pos, num_samples=12,
                                              num_warmup=30, num_chains=n, generator=gen))
    full, part = runs
    # x @ precision is one batched product over the block's chains: rtol 1e-6
    torch.testing.assert_close(part.positions["x"], _rows(full.positions["x"]),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(part.step_size, _rows(full.step_size), rtol=1e-6, atol=0)
    assert torch.equal(part.infos.is_accepted, _rows(full.infos.is_accepted))


def _elementwise_vag(positions):
    """A chain-batched value+grad that touches each chain's row alone:
    log N(0, diag(1, 4, 9))."""
    x = positions["x"]
    scale = torch.tensor([1.0, 4.0, 9.0])
    return -0.5 * (x * x / scale).sum(dim=1), {"x": -x / scale}


def test_block_run_of_batched_nuts_gives_the_full_runs_rows():
    kernel = nuts_batched.build_batched_kernel(_elementwise_vag, max_tree_depth=4)
    x0 = torch.randn((C, 3), generator=torch.Generator().manual_seed(0))
    runs = []
    for gen, x in zip(_gens(5), (x0, _rows(x0))):
        state = nuts_batched.batched_init({"x": x}, _elementwise_vag)
        eps, ones = torch.full((x.shape[0],), 0.4), {"x": torch.ones_like(x)}
        xs, depths = [], []
        for _ in range(15):
            state, info = kernel(state, eps, ones, generator=gen)
            xs.append(state.position["x"])
            depths.append(info.depth)
        runs.append((torch.stack(xs), torch.stack(depths)))
    (full_x, full_d), (part_x, part_d) = runs
    assert torch.equal(part_x, _rows(full_x, 1)) and torch.equal(part_d, _rows(full_d, 1))
    assert len(full_d.unique()) > 1       # the trees differ between chains and draws


def test_block_run_of_gauge_gibbs_gives_the_full_runs_rows():
    metric, qmap = _kron()
    gibbs = make_whitened_gauge_gibbs(metric, metric.aux, qmap)
    rng = np.random.RandomState(1)
    e = {"weights": torch.from_numpy(rng.randn(C, 6, 4).astype(np.float32)),
         "bias": torch.from_numpy(rng.randn(C, 4).astype(np.float32))}
    grads = {k: -v for k, v in e.items()}
    logp = torch.from_numpy(rng.randn(C).astype(np.float32))
    outs = []
    for gen, cut in zip(_gens(2), (lambda t: t, _rows)):
        state = hmc.HMCState({k: cut(v) for k, v in e.items()}, cut(logp),
                             {k: cut(v) for k, v in grads.items()})
        for _ in range(3):
            state = gibbs(state, generator=gen)
        outs.append(state)
    full, part = outs
    assert torch.equal(part.logdensity, _rows(full.logdensity))
    for k in e:
        assert torch.equal(part.position[k], _rows(full.position[k]))
        assert torch.equal(part.logdensity_grad[k], _rows(full.logdensity_grad[k]))


@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "dropout"])
def test_block_run_of_sgmcmc_chains_gives_the_full_runs_rows(keyed):
    mlp = models.DropoutMLP(dim=5, hidden=4, n_classes=3, p_drop=0.3 if keyed else 0.0)
    g0 = torch.Generator().manual_seed(0)
    one = mlp.init_params(g0, "cpu")
    params = {k: v[None] + 0.1 * torch.randn((C,) + v.shape, generator=g0)
              for k, v in one.items()}
    X = torch.randn((40, 5), generator=g0)
    y = torch.nn.functional.one_hot(torch.randint(0, 3, (40,), generator=g0), 3).float()
    ld = mlp.make_batched_logdensity(40, dropout=keyed)
    kernel = sgmcmc.build_sghmc_kernel(ld, keyed=keyed)
    outs = []
    for gen, cut in zip(_gens(4), (lambda t: t, _rows)):
        p = {k: cut(v) for k, v in params.items()}
        n = p["W1"].shape[0]
        _, pos, infos = sgmcmc.run_sgmcmc_chains(
            kernel, sgmcmc.sghmc_init(p), n, (X, y), batch_size=8, num_steps=12,
            step_size_schedule=sgmcmc.constant_schedule(1e-3), collect_every=3, generator=gen)
        outs.append((pos, infos))
    (full, full_i), (part, part_i) = outs
    # the per-chain minibatches and masks are equal bit for bit; the forward is
    # a batched product (baddbmm) over the block's chains: rtol 1e-6
    for k in full:
        torch.testing.assert_close(part[k], _rows(full[k]), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(part_i.logdensity, _rows(full_i.logdensity), rtol=1e-5, atol=1e-5)


def test_default_path_draws_what_it_drew_before():
    """Pinned on the commit before the streams (same script, same seeds):
    without a block every site makes the torch call it made, in its order."""
    g = torch.Generator().manual_seed(11)
    like = {"w": torch.zeros(3, 2, 2), "b": torch.zeros(3, 2)}
    t = tree_randn_like(like, g)
    assert [float(t["w"][1, 0, 1]), float(t["b"][2, 0])] == [
        -0.26961955428123474, 0.38340649008750916]
    t = tree_batch_randn_like(like, g)
    assert [float(t["w"][1, 0, 1]), float(t["b"][2, 0])] == [
        -0.19287914037704468, -0.7571949362754822]
    d = nuts_batched.sample_draws(3, 4, 3, g, "cpu")
    assert [float(d.momentum[2, 1]), bool(d.direction[1, 2]), float(d.leaf_uniform[2, 3, 1]),
            float(d.bias_uniform[0, 2])] == [0.22133447229862213, False, 0.38473230600357056,
                                             0.826903223991394]
    m = metropolis.sample_draws(3, 4, g, "cpu")
    assert [float(m.log_factor[1]), float(m.noise[2, 3]), int(m.coordinate[0]),
            float(m.accept_uniform[2])] == [-0.3886876106262207, 0.46533676981925964, 0,
                                            0.902449369430542]
    model, ld = _mvn()
    pos = sampling.init_chain_positions(model.init_params, 3, jitter=1.0, generator=g,
                                        device="cpu")
    assert pos["x"].flatten().tolist() == [
        0.8625026941299438, -0.7375219464302063, 1.9513415098190308, 0.389615535736084,
        -0.7253478169441223, -0.6860430240631104]
    post = sampling.sample_posterior(lambda q: hmc.init(q, ld), hmc.build_kernel(ld, 5), pos,
                                     num_samples=6, num_warmup=10, num_chains=3, generator=g)
    np.testing.assert_allclose(post.positions["x"][:, -1].flatten().numpy(), [
        -0.6332857608795166, -1.2699331045150757, 1.9894729852676392, -0.3905565142631531,
        -0.06758926808834076, -1.3342891931533813], rtol=1e-5)
    mlp = models.DropoutMLP(dim=5, hidden=4, n_classes=3, p_drop=0.3)
    params = {k: v[None].expand((2,) + v.shape).clone()
              for k, v in mlp.init_params(g, "cpu").items()}
    X = torch.randn((7, 5), generator=g)
    y = torch.nn.functional.one_hot(torch.randint(0, 3, (7,), generator=g), 3).float()
    masks = mlp.draw_masks(params, X[:4], g)
    assert [int(mk.sum()) for mk in masks] == [20, 27, 23]
    kernel = sgmcmc.build_sghmc_kernel(mlp.make_batched_logdensity(7, dropout=True), keyed=True)
    _, p2, _ = sgmcmc.run_sgmcmc_chains(
        kernel, sgmcmc.sghmc_init(params), 2, (X, y), batch_size=4, num_steps=6,
        step_size_schedule=sgmcmc.constant_schedule(1e-3), collect_every=2, generator=g)
    np.testing.assert_allclose(p2["b3"][:, -1].flatten().numpy(), [
        -0.0006085407803766429, -0.00018662195361685008, 0.00046519856550730765,
        0.0001759352453518659, 0.00023314770078286529, 0.00016526153194718063], rtol=1e-4)
