"""Worker of the port's multi-process parity test (tests/test_torch_multiprocess.py).

Every rank of a ``torch.distributed`` group runs the same workloads on its
block (gloo on the CPU); rank 0 writes what it gathered to
``<outdir>/result.npz``.  The test runs the same workload functions in one
process, block by block, with layouts that carry no process group, and holds
the two against each other.

    python scripts/torch_multiprocess_worker.py --rank R --world 2 \\
        --rendezvous file:///tmp/rdv --outdir DIR

Workloads (one function each, shared with the test):
  hmc_workload        batched HMC on a whitened softmax posterior with the
                      gauge Gibbs move after every draw
  nuts_workload       lockstep batched NUTS (tree sizes per chain and draw)
  streaming_workload  sample_batched_streaming with mesh=: uninterrupted, and
                      stopped after 2 of 3 chunks and resumed from the global
                      checkpoint
  dp_value_and_grad   the full-batch softmax value+grad over 2 data shards
  sgmcmc_workload     run_sgmcmc_data_parallel, keyed dropout MLP, constant rows
  smc_workload        tempered SMC with injected SMCDraws over particle blocks
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CHAINS, DRAWS = 4, 12


def _softmax_problem(n=48, d=4, k=3, seed=0):
    import torch

    rng = np.random.RandomState(seed)
    X = torch.from_numpy(rng.randint(0, 16, (n, d)).astype(np.float32) / 16.0)
    yi = rng.randint(0, k, n)
    Y = torch.from_numpy(np.eye(k, dtype=np.float32)[yi])
    return X, Y


def _whitened(layout):
    """Whitened value+grad, grad-only and gauge Gibbs of a small softmax
    posterior, with dims (D, K); the metric is rank 0's (shared_gn_setup)."""
    from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric

    X, Y = _softmax_problem()
    model = Softmax(dim=X.shape[1], n_classes=Y.shape[1], alpha=1.0)
    metric, aux, qmap, _ = kron_metric.shared_gn_setup(X, Y, model, 1.0, layout=layout,
                                                       newton_steps=10, n_classes=Y.shape[1])
    vag, grad = kron_metric.make_whitened_fused_vag(model, metric, qmap, (X, Y))
    gibbs = kron_metric.make_whitened_gauge_gibbs(metric, aux, qmap)
    return vag, grad, gibbs, X.shape[1], Y.shape[1]


def _block_gen(layout, seed):
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import chain_block

    block = chain_block(layout, CHAINS)
    return streams.block_generator(seed, "cpu", block), block.size


def _e0(gen, c, d, k):
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams

    return {"weights": streams.randn((c, d, k), generator=gen, device="cpu"),
            "bias": streams.randn((c, k), generator=gen, device="cpu")}


def hmc_workload(layout):
    """Batched HMC (L = 4) with gauge Gibbs; returns the gathered
    {weights, bias, accepted} (chains leading) on rank 0, else None."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import gather, sample_batched_sharded

    vag, grad, gibbs, d, k = _whitened(layout)
    gen, c = _block_gen(layout, 3)
    e0 = _e0(gen, c, d, k)
    kernel = hmc.build_batched_kernel(vag, 4, grad_fn=grad)
    _, pos, infos = sample_batched_sharded(
        kernel, hmc.batched_init(e0, vag), torch.full((c,), 0.4), {kk: torch.ones_like(v)
                                                                   for kk, v in e0.items()},
        DRAWS, layout, generator=gen, post_step=gibbs)
    return gather(dict(pos, accepted=infos.is_accepted), layout)


def nuts_workload(layout):
    """Lockstep NUTS (cap 3); returns {weights, bias, leaves} gathered."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import gather, sample_batched_sharded

    vag, _, _, d, k = _whitened(layout)
    gen, c = _block_gen(layout, 5)
    e0 = _e0(gen, c, d, k)
    kernel = nuts_batched.build_batched_kernel(vag, max_tree_depth=3)
    _, pos, infos = sample_batched_sharded(
        kernel, nuts_batched.batched_init(e0, vag), torch.full((c,), 0.3),
        {kk: torch.ones_like(v) for kk, v in e0.items()}, DRAWS, layout, generator=gen)
    return gather(dict(pos, leaves=infos.num_integration_steps), layout)


def streaming_workload(layout, workdir):
    """Lockstep NUTS streamed in chunks of 4 into a DeviceBackend: run A
    uninterrupted, run B stopped after 8 draws and resumed from its
    checkpoint with placeholder states and step sizes.  Returns {"a": ...,
    "b": ..., "summary": (chunks, fields) of A} gathered."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched, sampling
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import gather

    vag, _, _, d, k = _whitened(layout)
    kernel = nuts_batched.build_batched_kernel(vag, max_tree_depth=3)
    mesh = layout if layout.distributed else None

    def run(backend, num, ckpt, resume=False, placeholder=False):
        gen, c = _block_gen(layout, 7)
        e0 = _e0(gen, c, d, k)
        step = torch.full((c,), 99.0 if placeholder else 0.3)
        return sampling.sample_batched_streaming(
            kernel, nuts_batched.batched_init(e0, vag), step,
            {kk: torch.ones_like(v) for kk, v in e0.items()}, backend, num_samples=num,
            chunk_size=4, checkpoint_path=os.path.join(workdir, ckpt), resume=resume,
            mesh=mesh, generator=gen)

    a = sampling.DeviceBackend(DRAWS)
    _, _, summaries = run(a, DRAWS, f"a{layout.rank}.ckpt" if mesh is None else "a.ckpt")
    b = sampling.DeviceBackend(DRAWS)
    ckpt = f"b{layout.rank}.ckpt" if mesh is None else "b.ckpt"
    run(b, 8, ckpt)
    if mesh is not None:
        torch.distributed.barrier()      # rank 0's checkpoint is on disk
    run(b, DRAWS, ckpt, resume=True, placeholder=True)
    got = gather({"a": a.draws(), "b": b.draws()}, layout)
    if got is not None:
        got["summary"] = torch.tensor([list(s) for s in summaries])
    return got


def shard_clash(layout, workdir):
    """Every rank claims chains [0, 1]: the first append must raise on every
    rank.  Returns the message."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.io import ShardedHDF5Backend

    with ShardedHDF5Backend(os.path.join(workdir, "clash.h5"), "w",
                            process_index=layout.rank, chain_indices=[0, 1]) as b:
        try:
            b.append({"x": torch.zeros((3, 2, 2))})
        except ValueError as e:
            return str(e)
    return None


def dp_params(c=3, d=5, k=3, seed=11):
    rng = np.random.RandomState(seed)
    return {"weights": (0.3 * rng.randn(c, d, k)).astype(np.float32),
            "bias": (0.1 * rng.randn(c, k)).astype(np.float32)}


def dp_data(n=64, d=5, k=3, seed=12):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    Y = np.eye(k, dtype=np.float32)[rng.randint(0, k, n)]
    return X, Y


def dp_value_and_grad(layout_dp):
    """The full-batch softmax value and gradient summed over the data shards
    of ``layout_dp``; returns (value, {weights, bias}) as numpy."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import (make_sharded_value_and_grad,
                                                                    shard_data)

    X, Y = (torch.from_numpy(a) for a in dp_data())
    model = Softmax(dim=X.shape[1], n_classes=Y.shape[1], alpha=0.5)
    vag = make_sharded_value_and_grad(model, X.shape[0], layout_dp)
    v, g = vag({kk: torch.from_numpy(a) for kk, a in dp_params().items()},
               shard_data((X, Y), layout_dp))
    return v.numpy(), {kk: a.numpy() for kk, a in g.items()}


def mlp_problem(n=64, d=6, k=3, seed=2):
    """The keyed dropout MLP on constant rows (every minibatch has the same
    content), SGLD states of 2 chains."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgmcmc
    from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP

    rng = np.random.RandomState(seed)
    X = torch.from_numpy(np.tile(rng.randn(1, d).astype(np.float32), (n, 1)))
    Y = torch.from_numpy(np.eye(k, dtype=np.float32)[np.full(n, 1)])
    model = DropoutMLP(dim=d, hidden=8, n_classes=k, alpha=1.0, p_drop=0.1)
    g = torch.Generator().manual_seed(seed)
    pos = {kk: torch.stack([model.init_params(g, "cpu")[kk] for _ in range(2)])
           for kk in model.init_params(g, "cpu")}
    return model, (X, Y), sgmcmc.sgld_init(pos)


def sgmcmc_workload(layout_dp):
    """Keyed-dropout SGLD, global batch 16, under ``layout_dp`` (one chain
    block): returns the positions {W1, ...} (2, T, ...)."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgmcmc
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import (make_sharded_value_and_grad,
                                                                    run_sgmcmc_data_parallel)

    model, data, states = mlp_problem()
    vag = make_sharded_value_and_grad(model, data[0].shape[0], layout_dp, keyed=True)
    kernel = sgmcmc.build_sgld_kernel(keyed=True, value_and_grad_fn=vag)
    _, pos, _ = run_sgmcmc_data_parallel(
        kernel, states, 2, data, layout_dp, batch_size=16, num_steps=20,
        step_size_schedule=sgmcmc.constant_schedule(1e-4), collect_every=2,
        generator=streams.block_generator(4, "cpu", None))
    return pos


SMC_PARTICLES, SMC_OBS = 16, 32


def smc_draws(num_stages=60, rounds=2, seed=21):
    """Injected SMCDraws for every stage the ladder may take, from numpy."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.inference.smc import SMCDraws

    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return [SMCDraws(u0=t(np.asarray(rng.rand() / SMC_PARTICLES)),
                     rounds=[{"momentum": {"mu": t(rng.randn(SMC_PARTICLES, 2))},
                              "uniforms": t(rng.rand(SMC_PARTICLES)),
                              "jitter_uniforms": t(rng.rand(SMC_PARTICLES))}
                             for _ in range(rounds)])
            for _ in range(num_stages)]


def smc_workload(layout):
    """Tempered SMC (HMC mutation, 2 rounds of 4 steps) on a 2-D Gaussian
    mean; the particles lie in blocks over ``layout``'s chains axis.
    Returns (num_stages, log_evidence, gathered particles)."""
    import torch
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc, smc
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import chain_block, gather

    rng = np.random.RandomState(20)
    y = torch.from_numpy((1.5 + rng.randn(SMC_OBS)).astype(np.float32))
    block = chain_block(layout, SMC_PARTICLES)
    init = torch.from_numpy(rng.randn(SMC_PARTICLES, 2).astype(np.float32))

    def log_prior(p):
        return -0.5 * (p["mu"] ** 2).sum(dim=-1)

    def log_lik(p):
        return (-0.5 * (y[:, None, None] - p["mu"][None]) ** 2).sum(dim=(0, 2))

    log_prior.chain_batched = log_lik.chain_batched = True
    state, info = smc.run_tempered_smc(
        {"mu": init[block.start:block.stop]}, log_prior, log_lik,
        kernel_builder=lambda ld: hmc.build_kernel(ld, 4),
        init_builder=lambda ld: (lambda p: hmc.init(p, ld)),
        step_size=0.2, num_mcmc_steps=2, target_ess=0.6, draws=smc_draws(),
        layout=layout if layout.distributed else None)
    particles = gather(state.particles, layout)
    return int(info.num_stages), float(state.log_evidence), particles


def main() -> None:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rendezvous", required=True)
    p.add_argument("--outdir", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)

    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import init_distributed, make_layout

    init_distributed(args.rendezvous, args.world, args.rank, device="cpu")
    layout = make_layout()                         # (world, 1): chains
    layout_dp = make_layout(1, args.world)         # (1, world): data
    out = {}

    def keep(prefix, tree):
        if tree is not None:
            for kk, v in tree.items():
                out[f"{prefix}/{kk}"] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)

    keep("hmc", hmc_workload(layout))
    keep("nuts", nuts_workload(layout))
    got = streaming_workload(layout, args.outdir)
    if got is not None:
        keep("stream_a", got["a"])
        keep("stream_b", got["b"])
        out["stream_summary"] = got["summary"].numpy()
    out["clash"] = np.asarray(shard_clash(layout, args.outdir) or "")
    v, g = dp_value_and_grad(layout_dp)
    out["dp_value"] = v
    keep("dp_grad", g)
    keep("sgmcmc", sgmcmc_workload(layout_dp))
    stages, evidence, particles = smc_workload(layout)
    out["smc_stages"], out["smc_evidence"] = np.asarray(stages), np.asarray(evidence)
    keep("smc", particles)
    torch.distributed.barrier()
    if args.rank == 0:
        np.savez(os.path.join(args.outdir, "result.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
