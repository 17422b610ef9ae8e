"""The port's parallel/ layer in one process: the (chains, data) layout of
ranks, init_distributed's refusals, the block streams of the sharded
samplers against the unblocked run, the data-parallel value+grad against the
JAX package's on its 8-device CPU mesh, and the options that lay a run over
ranks.  The real collectives run in tests/test_torch_multiprocess.py.

Mirrors tests/test_parallel.py.  A block of chains is run here with a layout
that carries no process group (the layout of one rank of a larger run), on a
generator that carries the block.  Blocks of 2 chains against the batch of 4
may round the softmax GEMM otherwise, so positions are held to 2e-3 (the
JAX package's bound for its sharded NUTS) and tree sizes exactly; the MVN
per-chain HMC's ``x @ P`` to rtol 1e-6 (as in tests/test_torch_streams.py).
"""

import os

import numpy as np
import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch.parallel import (RankLayout, chain_block,
                                                                init_distributed, make_layout,
                                                                make_sharded_value_and_grad,
                                                                run_sgmcmc_data_parallel,
                                                                sample_batched_sharded,
                                                                sample_posterior_sharded,
                                                                shard_data)
from dropout_hamiltonian_montecarlo_tpu_torch.parallel.data import shard_rows
from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams
from dropout_hamiltonian_montecarlo_tpu_torch.ops.streams import ChainBlock

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def test_layout_shapes_and_host_contiguous_ordering():
    """8 ranks as 4 chain blocks x 2 data shards, 4 ranks a host (torchrun
    numbers a host's ranks contiguously): a chain block's data shards, which
    all-reduce gradients, share a host, as make_multihost_mesh lays them."""
    hosts = lambda r: r // 4  # noqa: E731
    seen = set()
    for r in range(8):
        lay = RankLayout(4, 2, r)
        assert (lay.chain_index, lay.data_index) == divmod(r, 2)
        assert r in lay.data_ranks() and r in lay.chains_ranks()
        assert {hosts(q) for q in lay.data_ranks()} == {hosts(r)}
        assert len(lay.chains_ranks()) == 4 and len(set(lay.chains_ranks())) == 4
        seen.add((lay.chain_index, lay.data_index))
        assert not lay.distributed
        assert chain_block(lay, 16) == ChainBlock(16, 4 * lay.chain_index,
                                                   4 * lay.chain_index + 4)
    assert len(seen) == 8
    with pytest.raises(ValueError):
        RankLayout(2, 2, 4)
    with pytest.raises(ValueError):
        chain_block(RankLayout(3, 1, 0), 16)


def test_make_layout_of_one_process(no_torchrun):
    lay = make_layout()
    assert (lay.num_chain_shards, lay.num_data_shards, lay.rank) == (1, 1, 0)
    assert not lay.distributed
    with pytest.raises(ValueError, match="torchrun"):
        make_layout(num_chain_shards=2)


def test_init_distributed_is_a_noop_for_one_process(no_torchrun):
    assert init_distributed(num_processes=1) == 0
    assert init_distributed() == 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kwargs", [
    dict(coordinator_address="localhost", num_processes=2, process_id=0),
    dict(coordinator_address="localhost:port", num_processes=2, process_id=0),
    dict(coordinator_address="localhost:29500", num_processes=2, process_id=2),
    dict(coordinator_address="localhost:29500", num_processes=2),
    dict(num_processes=2, process_id=0),
])
def test_init_distributed_raises_on_a_bad_explicit_coordinator(no_torchrun, kwargs):
    """An explicit group that cannot be joined raises; it never falls back to
    one process."""
    with pytest.raises(ValueError):
        init_distributed(device="cpu", **kwargs)
    assert not torch.distributed.is_initialized()


def test_init_distributed_refuses_nccl_with_two_ranks_on_one_device(no_torchrun, monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="NCCL.*gloo"):
        init_distributed("localhost:29500", 2, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_shard_rows_trailing_remainder():
    """Equal contiguous blocks in shard order; a trailing remainder is
    refused, since every shard scales its likelihood by its rows times the
    shard count (10 rows over 3 shards would weight them 10/12, 10/12,
    10/6)."""
    assert [shard_rows(12, RankLayout(1, 3, r)) for r in range(3)] == [(0, 4), (4, 8), (8, 12)]
    assert [shard_rows(60000, RankLayout(1, 2, r)) for r in range(2)] == [(0, 30000),
                                                                         (30000, 60000)]
    X = torch.arange(12.0)[:, None]
    parts = [shard_data((X,), RankLayout(2, 3, r))[0] for r in range(3)]
    assert torch.equal(torch.cat(parts), X)
    for r in range(3):
        with pytest.raises(ValueError, match="10 rows % 3 data shards"):
            shard_rows(10, RankLayout(1, 3, r))


@pytest.mark.parametrize("rows", [10, 11])
def test_sample_batched_sharded_refuses_ragged_data_shards(rows):
    """The full-batch data path of ``sample_batched_sharded`` raises on rows
    that the data shards do not divide, before it builds the kernel."""
    built = []
    data = (torch.zeros(rows, 2), torch.zeros(rows, 3))
    with pytest.raises(ValueError, match=f"{rows} rows % 3 data shards"):
        sample_batched_sharded(None, None, torch.ones(2), None, 1, RankLayout(1, 3, 2),
                               generator=streams.block_generator(0, "cpu"), data=data,
                               kernel_factory=built.append)
    assert not built


def _mvn_logdensity():
    from dropout_hamiltonian_montecarlo_tpu_torch.models import MVNGaussian

    cov = torch.tensor([[1.5, 0.5], [0.5, 1.5]])
    return MVNGaussian(torch.zeros(2), cov)


def test_sample_posterior_sharded_blocks_give_the_full_runs_rows():
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu_torch.inference.sampling import (
        init_chain_positions, sample_posterior)

    model = _mvn_logdensity()
    ld = model.make_logdensity()
    kernel = hmc.build_kernel(ld, 8)

    def run(layout, gen):
        block = chain_block(layout, 4)
        pos = init_chain_positions(model.init_params, block.size, jitter=1.0, generator=gen,
                                   device="cpu")
        return sample_posterior_sharded(lambda p: hmc.init(p, ld), kernel, pos, layout, 30,
                                        num_warmup=20, num_chains=4, generator=gen,
                                        initial_step_size=0.5)

    gen = torch.Generator().manual_seed(3)
    full = sample_posterior(
        lambda p: hmc.init(p, ld), kernel,
        init_chain_positions(model.init_params, 4, jitter=1.0, generator=gen, device="cpu"),
        30, num_warmup=20, num_chains=4, initial_step_size=0.5, generator=gen)
    blocks = [run(RankLayout(2, 1, r), streams.block_generator(3, "cpu", ChainBlock(4, 2 * r,
                                                                                   2 * r + 2)))
              for r in range(2)]
    x = torch.cat([b.positions["x"] for b in blocks])
    assert x.shape == (4, 30, 2)
    np.testing.assert_allclose(x.numpy(), full.positions["x"].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch.cat([b.step_size for b in blocks]).numpy(),
                               full.step_size.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="chain block"):
        run(RankLayout(2, 1, 1), torch.Generator().manual_seed(3))


def test_load_checkpoint_reads_a_blocks_rows(tmp_path):
    from dropout_hamiltonian_montecarlo_tpu_torch.io.checkpoint import (load_checkpoint,
                                                                       save_checkpoint)

    state = {"x": torch.arange(12.0).reshape(4, 3)}
    path = str(tmp_path / "c.ckpt")
    save_checkpoint(path, state, seed=5, step=8, extras={"step_size": torch.arange(4.0)})
    got, seed, step, extras = load_checkpoint(
        path, {"x": torch.zeros(2, 3)}, extras_like={"step_size": torch.zeros(2)},
        block=ChainBlock(4, 2, 4))
    assert (seed, step) == (5, 8)
    assert torch.equal(got["x"], state["x"][2:]) and torch.equal(extras["step_size"],
                                                                  torch.tensor([2.0, 3.0]))
    with pytest.raises(ValueError, match="chain axis"):
        load_checkpoint(path, {"x": torch.zeros(2, 3)}, block=ChainBlock(8, 0, 2))


def test_sharded_value_and_grad_sums_to_the_jax_psum_on_8_devices():
    """The JAX package's make_sharded_value_and_grad under shard_map on the
    8-device CPU mesh (tests/conftest.py) and the port's on the same numpy
    inputs: the autograd path's 8 shard terms (prior / 8, likelihood scaled
    by the global batch) summed here, and the fused-kernel path (its plain
    version on the CPU) on one shard of every row.  Value within 1e-3,
    gradient within 1e-5 (tests/test_multiprocess.py)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax
    from dropout_hamiltonian_montecarlo_tpu.parallel import make_mesh
    from dropout_hamiltonian_montecarlo_tpu.parallel.data import (
        make_sharded_value_and_grad as jax_vag)
    from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    n, d, k = 64, 4, 3
    rng = np.random.RandomState(0)
    X = rng.randn(n, d).astype(np.float32)
    Y = np.eye(k, dtype=np.float32)[rng.randint(0, k, n)]
    W = (0.3 * rng.randn(d, k)).astype(np.float32)
    b = (0.1 * rng.randn(k)).astype(np.float32)

    mesh = make_mesh(num_chain_shards=1, num_data_shards=8)
    f = jax.shard_map(jax_vag(JaxSoftmax(dim=d, n_classes=k, alpha=0.5), data_size=n),
                      mesh=mesh, in_specs=(P(), P("data")), out_specs=(P(), P()),
                      check_vma=False)
    v_jax, g_jax = f({"weights": jnp.asarray(W), "bias": jnp.asarray(b)},
                     (jnp.asarray(X), jnp.asarray(Y)))

    model = Softmax(dim=d, n_classes=k, alpha=0.5)
    params = {"weights": torch.from_numpy(W)[None], "bias": torch.from_numpy(b)[None]}
    data = (torch.from_numpy(X), torch.from_numpy(Y))
    total_v, total_g = 0.0, {"weights": 0.0, "bias": 0.0}
    for r in range(8):
        lay = RankLayout(1, 8, r)
        Xl, Yl = shard_data(data, lay)
        v, g = make_sharded_value_and_grad(model, n, lay)(params, (Xl[None], Yl[None]))
        total_v = total_v + v
        total_g = {kk: total_g[kk] + g[kk] for kk in g}
    v_one, g_one = make_sharded_value_and_grad(model, n, RankLayout(1, 1, 0))(params, data)
    for v, g in ((total_v, total_g), (v_one, g_one)):
        np.testing.assert_allclose(v.numpy()[0], float(v_jax), rtol=0, atol=1e-3)
        for kk in g:
            np.testing.assert_allclose(g[kk].numpy()[0], np.asarray(g_jax[kk]), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("algorithm", ["sgld", "sghmc"])
def test_one_data_shard_is_run_sgmcmc_chains_bit_for_bit(algorithm):
    """The data-parallel driver with one data shard and no group against
    run_sgmcmc_chains on the keyed dropout MLP: the same draws, bit for bit
    (tests/test_parallel.py asks 1e-6; the port's arithmetic is the same)."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgmcmc
    from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP

    rng = np.random.RandomState(1)
    n, d, k, c = 96, 6, 3, 3
    X = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    Y = torch.from_numpy(np.eye(k, dtype=np.float32)[rng.randint(0, k, n)])
    model = DropoutMLP(dim=d, hidden=8, n_classes=k, alpha=1.0, p_drop=0.2)
    g = torch.Generator().manual_seed(0)
    one = [model.init_params(g, "cpu") for _ in range(c)]
    pos = {kk: torch.stack([p[kk] for p in one]) for kk in one[0]}
    init = sgmcmc.sghmc_init if algorithm == "sghmc" else sgmcmc.sgld_init
    build = sgmcmc.build_sghmc_kernel if algorithm == "sghmc" else sgmcmc.build_sgld_kernel
    run = dict(batch_size=16, num_steps=24, step_size_schedule=sgmcmc.constant_schedule(1e-4),
               collect_every=3, burnin_steps=6)

    ref = sgmcmc.run_sgmcmc_chains(
        build(model.make_batched_logdensity(data_size=n, dropout=True), keyed=True), init(pos),
        c, (X, Y), generator=torch.Generator().manual_seed(4), **run)
    lay = RankLayout(1, 1, 0)
    dp = run_sgmcmc_data_parallel(
        build(keyed=True, value_and_grad_fn=make_sharded_value_and_grad(model, n, lay,
                                                                         keyed=True)),
        init(pos), c, (X, Y), lay, generator=streams.block_generator(4, "cpu"), **run)
    for kk in ref[1]:
        assert torch.equal(dp[1][kk], ref[1][kk]), kk
    assert torch.equal(dp[2].logdensity, ref[2].logdensity)


def test_data_parallel_driver_checks_its_shapes():
    with pytest.raises(ValueError, match="batch_size"):
        run_sgmcmc_data_parallel(None, None, 2, (torch.zeros(8, 2),), RankLayout(1, 2, 0),
                                 batch_size=5, num_steps=1, step_size_schedule=None,
                                 generator=None)
    with pytest.raises(ValueError, match="rows"):
        run_sgmcmc_data_parallel(None, None, 2, (torch.zeros(9, 2),), RankLayout(1, 2, 0),
                                 batch_size=4, num_steps=1, step_size_schedule=None,
                                 generator=None)


def test_bench_chees_block_adapts_the_full_runs_step():
    """ChEES adapts one step from every chain: under a layout each rank warms
    up all chains, so a block's run adapts the full run's step, exactly."""
    from dropout_hamiltonian_montecarlo_tpu_torch import bench

    kw = dict(device="cpu", chains=4, warmup=6, draws=4, dataset="digits", chees=True)
    full = bench.run(**kw)["detail"]
    block = bench.run(layout=RankLayout(2, 1, 1), **kw)["detail"]
    assert block["chains"] == 2 and block["chain_shards"] == 2
    assert block["step_size_median"] == full["step_size_median"]
    assert block["num_integration_steps"] == full["num_integration_steps"]


def test_nothing_is_left_not_ported():
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "dropout_hamiltonian_montecarlo_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert "not ported yet" not in f.read(), name
