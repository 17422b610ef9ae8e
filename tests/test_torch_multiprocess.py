"""Two real processes in a gloo group against the one-process run of the
same workloads (the port's parallel/ layer on torch.distributed).

One worker program (scripts/torch_multiprocess_worker.py) runs every
workload on two ranks that meet at a file rendezvous (no port); the test
runs the same workload functions here, block by block, with layouts that
carry no process group.  Where the two compute the same blocks (the same
shapes), the collectives must change no number: draws, tree sizes and the
resumed stream are compared bit for bit.  Against the full one-process
batch the tolerances are stated at each assertion.  A last test starts the
CLI under torchrun with ``--chain-shards 2``.  Imports no jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch.parallel import RankLayout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_multiprocess_worker as worker  # noqa: E402

TIMEOUT_S = 240


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _run_all(procs, logs):
    try:
        for p in procs:
            rc = p.wait(timeout=TIMEOUT_S)
            assert rc == 0, _tail(logs, "a rank failed")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _tail(logs, msg):
    parts = [msg]
    for path in logs:
        if os.path.exists(path):
            parts.append(f"--- {os.path.basename(path)} ---")
            with open(path) as f:
                parts.extend(f.read().splitlines()[-25:])
    return "\n".join(parts)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The worker's results of two gloo ranks (rank 0's result.npz)."""
    out = tmp_path_factory.mktemp("ranks")
    rdv = f"file://{out}/rdv"
    procs, logs = [], []
    for rank in range(2):
        log = str(out / f"rank{rank}.log")
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "scripts", "torch_multiprocess_worker.py"),
                 "--rank", str(rank), "--world", "2", "--rendezvous", rdv,
                 "--outdir", str(out)],
                cwd=REPO, env=_env(), stdout=f, stderr=subprocess.STDOUT))
    _run_all(procs, logs)
    with np.load(out / "result.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blockwise(fn, *args):
    """``fn`` run here on the two chain blocks, one after the other, with
    layouts without a process group; the blocks' tensors concatenated."""
    parts = [fn(RankLayout(2, 1, r), *args) for r in range(2)]
    return {k: torch.cat([p[k] for p in parts]).numpy() for k in parts[0]}


def _full(fn, *args):
    return {k: v.numpy() for k, v in fn(RankLayout(1, 1, 0), *args).items()}


@pytest.mark.parametrize("workload", ["hmc", "nuts"])
def test_two_ranks_give_the_blockwise_draws_bit_for_bit(two_ranks, workload):
    ref = _blockwise(getattr(worker, f"{workload}_workload"))
    for k, v in ref.items():
        got = two_ranks[f"{workload}/{k}"]
        assert got.shape[:2] == (worker.CHAINS, worker.DRAWS)
        np.testing.assert_array_equal(got, v, err_msg=f"{workload}/{k}")


def test_blockwise_hmc_and_nuts_against_the_unblocked_run():
    """Blocks of 2 chains against the batch of 4: the plain softmax's GEMM
    over C K columns may round otherwise, so positions agree to 2e-3 (the
    JAX package's sharded-NUTS bound, tests/test_parallel.py) and NUTS tree
    sizes exactly."""
    for fn in (worker.hmc_workload, worker.nuts_workload):
        blocks, full = _blockwise(fn), _full(fn)
        for k in ("weights", "bias"):
            np.testing.assert_allclose(blocks[k], full[k], rtol=0, atol=2e-3)
    np.testing.assert_array_equal(blocks["leaves"], full["leaves"])


def test_blockwise_streaming_against_the_unblocked_run(tmp_path):
    """The streaming driver block by block against all chains at once (2e-3,
    as above), the resumed stream included."""
    parts = [worker.streaming_workload(RankLayout(2, 1, r), str(tmp_path)) for r in range(2)]
    full = worker.streaming_workload(RankLayout(1, 1, 0), str(tmp_path))
    for run in ("a", "b"):
        for k in ("weights", "bias"):
            block = torch.cat([p[run][k] for p in parts]).numpy()
            np.testing.assert_allclose(block, full[run][k].numpy(), rtol=0, atol=2e-3)


def test_streaming_with_a_global_checkpoint_stopped_and_resumed(two_ranks, tmp_path):
    # the resumed 2-rank run equals the uninterrupted one bit for bit
    for k in ("weights", "bias"):
        np.testing.assert_array_equal(two_ranks[f"stream_b/{k}"], two_ranks[f"stream_a/{k}"])
    # and equals the blockwise one-process run
    parts = [worker.streaming_workload(RankLayout(2, 1, r), str(tmp_path)) for r in range(2)]
    for k in ("weights", "bias"):
        block = torch.cat([p["a"][k] for p in parts]).numpy()
        np.testing.assert_array_equal(two_ranks[f"stream_a/{k}"], block)
    # the chunk summaries are means over ALL chains: the blocks' mean (equal
    # blocks), to float32 rounding of the means
    mean = 0.5 * (parts[0]["summary"] + parts[1]["summary"]).numpy()
    np.testing.assert_allclose(two_ranks["stream_summary"], mean, rtol=1e-6, atol=1e-6)


def test_shard_clash_raises_at_the_first_append(two_ranks):
    assert "claim the same chains" in str(two_ranks["clash"])


def test_data_parallel_value_and_grad_equals_the_full_batch(two_ranks):
    """Tolerances of tests/test_multiprocess.py: value 1e-3, gradient 1e-5."""
    from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax

    X, Y = (torch.from_numpy(a) for a in worker.dp_data())
    model = Softmax(dim=X.shape[1], n_classes=Y.shape[1], alpha=0.5)
    params = {k: torch.from_numpy(a).requires_grad_(True) for k, a in worker.dp_params().items()}
    value = model.log_prior(params) + model.log_likelihood(params, (X, Y))
    grads = torch.autograd.grad(value.sum(), list(params.values()))
    np.testing.assert_allclose(two_ranks["dp_value"], value.detach().numpy(), rtol=0, atol=1e-3)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(two_ranks[f"dp_grad/{k}"], g.numpy(), rtol=0, atol=1e-5)


def test_data_parallel_sgmcmc_constant_rows_exact_across_two_shards(two_ranks):
    """Two data shards of a global batch of 16 against one process at a batch
    of 8: on constant rows every minibatch has the same content, the draws
    (indices, noise, dropout masks of 8 rows) have the same shapes, and every
    scale is a power of two, so the draws agree bit for bit."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgmcmc
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams

    model, data, states = worker.mlp_problem()
    ld = model.make_batched_logdensity(data_size=data[0].shape[0], dropout=True)
    _, pos, _ = sgmcmc.run_sgmcmc_chains(
        sgmcmc.build_sgld_kernel(ld, keyed=True), states, 2, data, batch_size=8, num_steps=20,
        step_size_schedule=sgmcmc.constant_schedule(1e-4), collect_every=2,
        generator=streams.block_generator(4, "cpu", None))
    for k, v in pos.items():
        np.testing.assert_array_equal(two_ranks[f"sgmcmc/{k}"], v.numpy(), err_msg=k)


def test_sharded_smc_with_injected_draws(two_ranks):
    """Particle blocks on two ranks against one process, the same injected
    SMCDraws: the same ladder (stage count), the log evidence within 1e-3
    (the 2-rank log likelihoods come from blocks of 8 particles), and the
    particles within 1e-3."""
    stages, evidence, particles = worker.smc_workload(RankLayout(1, 1, 0))
    assert int(two_ranks["smc_stages"]) == stages
    assert abs(float(two_ranks["smc_evidence"]) - evidence) < 1e-3
    np.testing.assert_allclose(two_ranks["smc/mu"], particles["mu"].numpy(), rtol=0, atol=1e-3)


def test_cli_chain_shards_under_torchrun_gives_the_blockwise_draws(tmp_path, monkeypatch):
    """``mnist-nuts --chain-shards 2`` on two torchrun ranks writes one shard
    file per rank; reassembled, they hold the draws of the same command run
    here block by block, bit for bit."""
    from dropout_hamiltonian_montecarlo_tpu_torch import cli
    from dropout_hamiltonian_montecarlo_tpu_torch.io import assemble_shards, shard_paths

    common = ["mnist-nuts", "--dataset", "digits", "--chains", "4", "--samples", "10",
              "--warmup", "10", "--max-depth", "3", "--stream-chunk", "5", "--device", "cpu"]
    base = str(tmp_path / "sharded.h5")
    log = str(tmp_path / "torchrun.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "dropout_hamiltonian_montecarlo_tpu_torch.cli",
             *common, "--chain-shards", "2", "--save", base],
            cwd=REPO, env=_env(), stdout=f, stderr=subprocess.STDOUT)
        _run_all([proc], [log])
    with open(log) as f:
        line = json.loads([ln for ln in f if ln.startswith("{")][-1])
    assert line["chain_shards"] == 2 and line["train_accuracy"] > 0.8
    sharded = assemble_shards(shard_paths(base, 2))

    blocks = []
    for r in range(2):
        monkeypatch.setattr(cli, "_join", lambda args, *a, r=r, **k: (torch.device("cpu"),
                                                                       RankLayout(2, 1, r)))
        path = str(tmp_path / f"block{r}.h5")
        cli.main(common + ["--chain-shards", "2", "--save", path])
        blocks.append(_read(path))
    for k in ("weights", "bias"):
        np.testing.assert_array_equal(sharded[k], np.concatenate([b[k] for b in blocks], axis=1))


def _read(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in ("weights", "bias")}


def test_bench_chain_shards_under_torchrun_traces_each_rank(tmp_path):
    """``BENCH_CHAIN_SHARDS=2`` on two torchrun ranks: rank 0 alone prints the
    line, over all chains, and ``BENCH_TRACE`` writes one trace a rank."""
    trace = tmp_path / "trace"
    env = dict(_env(), BENCH_CHAIN_SHARDS="2", BENCH_DATASET="digits", BENCH_CHAINS="4",
               BENCH_WARMUP="5", BENCH_DRAWS="5", BENCH_TRACE=str(trace))
    log = str(tmp_path / "torchrun.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "dropout_hamiltonian_montecarlo_tpu_torch.bench",
             "--device", "cpu"],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
        _run_all([proc], [log])
    with open(log) as f:
        lines = [json.loads(ln) for ln in f if ln.startswith("{")]
    assert len(lines) == 1
    detail = lines[0]["detail"]
    assert detail["chain_shards"] == 2 and detail["chains"] == 4 and detail["draws"] == 5
    for r in range(2):
        assert (trace / f"rank{r}" / "trace.json").is_file()
