"""Command-line entry point of the port.

    python -m dropout_hamiltonian_montecarlo_tpu_torch.cli <subcommand> [options]
    dhmc-torch <subcommand> [options]

  mvn-hmc           config 1: 2-D MVN target, multi-chain HMC (or --nuts)
  logistic-hmc      config 2: Bayesian logistic regression on blobs, 32 chains
  mnist-nuts        config 3: MNIST softmax, full-batch lockstep chain-batched
                    NUTS in the whitened Kronecker Gauss-Newton coordinates;
                    --per-chain-nuts runs the per-chain kernel with the
                    Kronecker metric, --diag-mass plain diagonal-mass NUTS
  mnist-mlp-sgmcmc  config 4: MNIST dropout MLP, minibatch SGLD / SGHMC with
                    the dropout masks inside the sampled potential
  plantvillage-smc  config 5: conv-feature softmax, adaptive tempered SMC
                    (HMC or minibatch-SGHMC mutation)
  mnist-vi          config 6: mean-field ADVI on the MNIST softmax or MLP

Each prints one JSON summary line with the keys of the JAX package's
``dhmc-tpu`` subcommand of the same name plus ``"device"`` (no ``compile_s``:
nothing is compiled).  The default device is cuda and the run fails without a
card; ``--device cpu`` must be asked for by name.

``--save FILE`` writes the draws to an HDF5 file the JAX package reads too;
with ``--stream-chunk N`` they are spooled in chunks of N while sampling, and
``--checkpoint FILE`` then writes a resumable checkpoint after every chunk:
``--resume`` skips warmup and goes on where the checkpoint stopped, and the
file ends up holding exactly the draws of an uninterrupted run.  ``--data
PATH`` reads the data from an HDF5 file.

The options that lay a run over ranks (``mnist-nuts --chain-shards N``,
``mnist-mlp-sgmcmc --data-shards N``, ``plantvillage-smc --shard-particles``)
run one process per rank, started by torchrun:

    torchrun --standalone --nproc-per-node 2 \
        -m dropout_hamiltonian_montecarlo_tpu_torch.cli mnist-nuts --chain-shards 2

Rank 0 prints the line.  ``--dist-backend`` names the collectives' backend
(default nccl on cuda, gloo on the CPU; two ranks on one card need gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .ops import streams
from .parallel.mesh import RankLayout, chain_block, gather

NUM_CLASSES = 10


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--step-size", type=float, default=0.1)
    p.add_argument("--save", type=str, default=None,
                   help="write posterior draws to this HDF5 file")
    p.add_argument("--stream-chunk", type=int, default=0,
                   help="with --save: spool draws to the file in chunks of this many "
                        "draws during sampling (0 = save once at the end)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="with --save --stream-chunk: atomically write a resumable "
                        "checkpoint (.npz) after every chunk")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists (skips warmup; use the "
                        "original --stream-chunk)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when named)")


def _dist_backend(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="under torchrun: the collectives' backend (default nccl on cuda, "
                        "gloo on the CPU; two ranks on one card need gloo)")


def _join(args, option: str, num_chain_shards=None, num_data_shards: int = 1):
    """(device, layout) of a run laid over ranks by ``option``.  Under
    torchrun it joins the group (``parallel.init_distributed``) and lays the
    ranks out; outside it only a layout of one process runs, and asking for
    more raises with the command to use: nothing falls back to one process."""
    from .parallel import init_distributed, local_device, make_layout

    if "WORLD_SIZE" not in os.environ:
        if (num_chain_shards or 1) * num_data_shards > 1:
            n = (num_chain_shards or 1) * num_data_shards
            raise SystemExit(
                f"{option} runs one process per rank, started by torchrun: torchrun "
                f"--standalone --nproc-per-node {n} -m dropout_hamiltonian_montecarlo_tpu_torch"
                f".cli {args.cmd} {option} ...")
        return _device(args), RankLayout(1, 1, 0)
    dev = local_device(_device(args))
    init_distributed(backend=args.dist_backend, device=dev)
    return dev, make_layout(num_chain_shards, num_data_shards)


def _resuming(args) -> bool:
    """Whether this run continues a checkpoint, after the checks the file
    options need.  ``--checkpoint`` / ``--resume`` need ``--save``: only a
    persistent backend holds the draws a resumed run goes on from.  The sample
    file is opened in append mode only when this returns True: a crash before
    the first checkpoint write must not leave a stale chunk under a fresh run.
    And ``--resume`` with a sample file but no checkpoint raises instead of
    overwriting the file."""
    if (args.resume or args.checkpoint) and not args.save:
        raise SystemExit("--checkpoint/--resume require --save (a persistent backend "
                         "holds the earlier draws)")
    resuming = bool(args.resume and args.checkpoint and os.path.exists(args.checkpoint))
    if args.resume and not resuming and os.path.exists(args.save):
        raise FileExistsError(
            f"--resume: there is no checkpoint at {args.checkpoint!r}, but the sample file "
            f"{args.save!r} exists and a fresh run would overwrite it; remove the file, or "
            f"drop --resume to start again")
    return resuming


def _device(args) -> torch.device:
    """The run's device; the entry points run on the card unless the CPU is
    named.  Also turns TF32 off: the values feed MH accepts."""
    from . import full_f32_precision

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    full_f32_precision()
    return dev


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _run_chains(args, init_fn, kernel, positions, gen, adapt_mass=True):
    """``sample_posterior`` with the common options, or, with ``--save`` and
    ``--stream-chunk``, the streaming form: the draws are spooled to the file
    chunk by chunk and read back.  Returns (positions with (chains, draws,
    ...) leading axes, streamed, run_s): warmup and sampling together, as the
    JAX CLI times them."""
    from .inference.sampling import sample_posterior, sample_posterior_streaming

    dev = next(iter(positions.values())).device
    resuming = _resuming(args)
    if args.save and args.stream_chunk > 0:
        from .io import HDF5Backend

        t0 = time.perf_counter()
        with HDF5Backend(args.save, mode="a" if resuming else "w") as b:
            sample_posterior_streaming(
                init_fn, kernel, positions, b, num_samples=args.samples,
                chunk_size=args.stream_chunk, num_warmup=args.warmup, num_chains=args.chains,
                initial_step_size=args.step_size, adapt_mass=adapt_mass,
                checkpoint_path=args.checkpoint, resume=args.resume, generator=gen)
            stored = b.read()
        run_s = time.perf_counter() - t0
        # (draws, chains, ...) in the file -> (chains, draws, ...) for the diagnostics
        return ({k: torch.from_numpy(v).to(dev).transpose(0, 1) for k, v in stored.items()},
                True, run_s)
    if args.checkpoint or args.resume:
        raise SystemExit("--checkpoint/--resume require --save and --stream-chunk (the "
                         "checkpoint is written after every spooled chunk)")

    t0 = time.perf_counter()
    post = sample_posterior(init_fn, kernel, positions, num_samples=args.samples,
                            num_warmup=args.warmup, num_chains=args.chains,
                            initial_step_size=args.step_size, adapt_mass=adapt_mass,
                            generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return post.positions, False, time.perf_counter() - t0


def _save_and_summarize(args, positions, elapsed, already_saved=False) -> dict:
    """The aggregate ESS / R-hat line of the draws; with ``--save`` (and the
    draws not already spooled) they are appended to the file first, chains
    and draws flattened into the leading axis as the JAX CLI writes them."""
    from .diagnostics import summarize

    if args.save and not already_saved:
        from .io import HDF5Backend

        with HDF5Backend(args.save) as b:
            b.append({k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in positions.items()})
    s = summarize(positions, elapsed_seconds=elapsed)
    return {k: float(v) for k, v in s["aggregate"].items()}


def cmd_mvn_hmc(args) -> dict:
    from .inference import hmc, nuts
    from .inference.sampling import init_chain_positions
    from .models import MVNGaussian

    dev = _device(args)
    a = 0.5 * torch.ones((args.dim, args.dim), device=dev)
    model = MVNGaussian(torch.zeros(args.dim, device=dev), a @ a.T + torch.eye(args.dim,
                                                                               device=dev))
    logdensity = model.make_logdensity()
    if args.nuts:
        kernel = nuts.build_kernel(logdensity)
        init_fn = lambda p: nuts.init(p, logdensity)   # noqa: E731
    else:
        kernel = hmc.build_kernel(logdensity, args.num_steps)
        init_fn = lambda p: hmc.init(p, logdensity)    # noqa: E731

    gen = torch.Generator(device=dev).manual_seed(int(args.seed))
    positions = init_chain_positions(model.init_params, args.chains, jitter=1.0,
                                     generator=gen, device=dev)
    draws, streamed, run_s = _run_chains(args, init_fn, kernel, positions, gen)
    agg = _save_and_summarize(args, draws, run_s, already_saved=streamed)
    agg.update({"workload": "mvn-hmc", "run_s": round(run_s, 2),
                "device": _device_name(dev)})
    print(json.dumps(agg), flush=True)
    return agg


def cmd_logistic_hmc(args) -> dict:
    from .inference import hmc
    from .inference.sampling import init_chain_positions
    from .io import datasets
    from .models import Logistic

    dev = _device(args)
    (Xtr, ytr), (Xte, yte) = [tuple(torch.from_numpy(a).to(dev) for a in part)
                              for part in datasets.blobs(n=args.n_data)]
    model = Logistic(dim=Xtr.shape[1], alpha=args.alpha)
    logdensity = model.make_logdensity(batch=(Xtr, ytr))
    kernel = hmc.build_kernel(logdensity, args.num_steps)

    gen = torch.Generator(device=dev).manual_seed(int(args.seed))
    positions = init_chain_positions(model.init_params, args.chains, jitter=0.5,
                                     generator=gen, device=dev)
    draws, streamed, run_s = _run_chains(args, lambda p: hmc.init(p, logdensity), kernel,
                                         positions, gen)
    pm = {k: v.mean(dim=(0, 1)) for k, v in draws.items()}
    acc = float((model.predict(pm, Xte) == yte).to(torch.float32).mean())
    agg = _save_and_summarize(args, draws, run_s, already_saved=streamed)
    agg.update({"workload": "logistic-hmc", "test_accuracy": acc, "run_s": round(run_s, 2),
                "device": _device_name(dev)})
    print(json.dumps(agg), flush=True)
    return agg


def _run_mnist_nuts_batched(args, model, metric, qmap, X, y, gen, layout,
                            draw_buffer_threshold=None):
    """Config 3's execution path: lockstep chain-batched NUTS in whitened
    coordinates, every leaf of every chain's tree through ONE fused
    value+grad call, warmup by per-chain dual averaging on the same kernel,
    sampling in chunks (``--stream-chunk``, default 50) into a bounded draw
    buffer, and the diagnostics (blocked ESS, split R-hat, posterior mean,
    predictive probabilities) computed where the draws lie.

    The buffer holds (chains, draws, parameters) floats.  While that is at
    most ``draw_buffer_threshold`` bytes (default: a quarter of the card's
    free memory) it lies on the device; above it, in pinned host memory, and
    the diagnostics take it in blocks.  ``--save`` spools every chunk to the
    file as well; a RESUMED run's earlier draws exist only in the file, so it
    reads the file back (blockwise, through host memory).

    ``layout`` with process groups (``--chain-shards``): this rank runs its
    chain block from warmup on, on ``gen``, which carries the block, so the
    adapted step sizes and the draws do not depend on the shard count; the
    chunk summaries are means over all chains; with ``--save`` each rank
    writes its shard file (``ShardedHDF5Backend``) and the checkpoint is
    global.  Rank 0 gathers the draws for the diagnostics; the other ranks
    return None.

    Returns (run_s, extra, results): the results hold the aggregate line,
    the posterior mean and the predictive probabilities."""
    from .diagnostics.calibration import posterior_predictive_probs
    from .diagnostics.ess import effective_sample_size
    from .diagnostics.rhat import split_rhat
    from .diagnostics.summary import draw_diagnostics, median
    from .inference import nuts_batched
    from .inference.sampling import (TeeDeviceBackend, choose_draw_storage, draw_bytes,
                                     sample_batched_streaming)
    from .inference.warmup import run_warmup
    from .ops.kron_metric import make_whitened_fused_vag
    from .ops.tree import tree_ones_like

    dev = X.device
    d, k, chains = X.shape[1], NUM_CLASSES, args.chains
    block = chain_block(layout, chains)
    sharded = layout.distributed
    c = block.size                       # this rank's chains
    batched_vag, _ = make_whitened_fused_vag(model, metric, qmap, (X, y))
    kernel = nuts_batched.build_batched_kernel(batched_vag, max_tree_depth=args.max_depth)
    resuming = _resuming(args)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    # Laplace init is exactly e ~ N(0, I) in whitened coordinates
    e0 = {"weights": streams.randn((c, d, k), generator=gen, device=dev),
          "bias": streams.randn((c, k), generator=gen, device=dev)}
    state0 = nuts_batched.batched_init(e0, batched_vag)
    if resuming:
        # warmup is skipped: the checkpoint carries the chain states and the
        # adapted step sizes, which replace these placeholders of the right shapes
        warm_state, warm_step = state0, torch.full((c,), args.step_size, device=dev)
        warm_s = 0.0
    else:
        warm = run_warmup(kernel, state0, args.warmup,
                          initial_step_size=torch.full((c,), args.step_size, device=dev),
                          target_acceptance=args.target_accept, adapt_mass=False,
                          generator=gen)
        warm_state, warm_step = warm.state, warm.step_size
        sync()
        warm_s = time.perf_counter() - t0
    inv_mass = tree_ones_like(e0)

    def to_param(pos_e):
        # whitened (C, T, ...) draws -> parameter space, one chain at a time
        out = {kk: torch.empty_like(v) for kk, v in pos_e.items()}
        for i in range(c):
            dq = metric.unwhiten({kk: v[i] for kk, v in pos_e.items()})
            for kk in out:
                out[kk][i] = qmap[kk] + dq[kk]
        return out

    chunk = args.stream_chunk if args.stream_chunk > 0 else min(max(args.samples, 1), 50)
    file_b = None
    if args.save:
        from .io import HDF5Backend, ShardedHDF5Backend

        mode = "a" if resuming else "w"
        file_b = (ShardedHDF5Backend(args.save, mode, process_index=layout.rank,
                                     chain_indices=range(block.start, block.stop))
                  if sharded else HDF5Backend(args.save, mode=mode))
    # a fresh run diagnoses the draws where the buffer holds them
    buffered = not resuming
    storage = choose_draw_storage(draw_bytes(c, args.samples, e0), dev,
                                  draw_buffer_threshold)
    t0 = time.perf_counter()
    with (TeeDeviceBackend(file_b, num_draws=args.samples, storage=storage)
          if buffered else file_b) as b:
        _, _, infos = sample_batched_streaming(
            kernel, warm_state, warm_step, inv_mass, b, num_samples=args.samples,
            chunk_size=chunk, transform=to_param, checkpoint_path=args.checkpoint,
            resume=args.resume, generator=gen, mesh=layout if sharded else None)
        if buffered:
            q = gather(b.draws(), layout)                # (C, T, ...) on rank 0
        elif not sharded:
            storage = "file"
            q = {kk: torch.from_numpy(v).transpose(0, 1) for kk, v in b.read().items()}
    sync()
    run_s = time.perf_counter() - t0
    if not buffered and sharded:
        from .io import assemble_shards, shard_paths

        # every shard file is closed: rank 0 reads them all back
        torch.distributed.barrier()
        storage = "file"
        q = (None if layout.rank != 0 else
             {kk: torch.from_numpy(v).transpose(0, 1) for kk, v in
              assemble_shards(shard_paths(args.save, layout.world_size)).items()})
    if q is None:
        return None

    # the rate counts the draws THIS call made (a resumed run restores the
    # earlier ones from the file): it ran the LAST len(infos) chunks, of which
    # the final one may be partial
    n_chunks = -(-args.samples // chunk)
    takes = [min(chunk, args.samples - i * chunk) for i in range(n_chunks)]
    made_draws = sum(takes[n_chunks - len(infos):]) if infos else 0
    extra = {"sampler": "batched-nuts", "warmup_s": round(warm_s, 2),
             "chain_shards": layout.num_chain_shards,
             "resumed": resuming,
             "draws_per_sec": round(chains * made_draws / max(run_s, 1e-9), 1)}

    # only the (n, k) predictive probabilities and a few scalars go to the host
    t1 = time.perf_counter()
    if storage == "device":
        ess = torch.cat([effective_sample_size(q["weights"], block_size=512).reshape(-1),
                         effective_sample_size(q["bias"]).reshape(-1)])
        rh = torch.cat([split_rhat(q["weights"]).reshape(-1),
                        split_rhat(q["bias"]).reshape(-1)])
        pm = {kk: v.mean(dim=(0, 1)) for kk, v in q.items()}
    else:
        diag = draw_diagnostics(q, dev)
        ess, rh, pm = diag["ess"], diag["rhat"], diag["mean"]
    pp = posterior_predictive_probs(lambda p, x: model.predict(p, x, prob=True), q, X,
                                    max_draws=32)
    agg = {"min_ess": float(ess.min()), "median_ess": float(median(ess)),
           "max_rhat": float(rh.max())}
    sync()
    diag_s = time.perf_counter() - t1
    agg["min_ess_per_sec"] = round(agg["min_ess"] / max(run_s, 1e-9), 1)
    agg["median_ess_per_sec"] = round(agg["median_ess"] / max(run_s, 1e-9), 1)
    if infos:
        extra.update({
            "mean_tree_depth": round(float(np.mean([i.depth for i in infos])), 2),
            "mean_leaves_per_draw": round(
                float(np.mean([i.num_integration_steps for i in infos])), 1),
            "mean_acceptance": round(float(np.mean([i.acceptance_prob for i in infos])), 4),
            "divergent_frac": round(float(np.mean([i.is_divergent for i in infos])), 6),
        })
    return run_s, extra, {"agg": agg, "pm": pm, "pp": pp, "diag_s": diag_s,
                          "draw_storage": storage}


def cmd_mnist_nuts(args, draw_buffer_threshold=None) -> dict:
    """``draw_buffer_threshold`` (bytes): see ``_run_mnist_nuts_batched``."""
    from .diagnostics import calibration_report, posterior_predictive_probs
    from .inference import nuts
    from .inference.sampling import init_chain_positions
    from .io import datasets
    from .models import Softmax
    from .ops.kron_metric import shared_gn_setup

    if args.chain_shards > 1 and (args.per_chain_nuts or args.diag_mass):
        raise SystemExit("--chain-shards lays the lockstep chain-batched path over ranks; "
                         "--per-chain-nuts and --diag-mass run in one process")
    dev, layout = _join(args, "--chain-shards", num_chain_shards=args.chain_shards)

    if args.dataset == "digits":
        # real bundled pixels (scikit-learn's 8x8 digits), k/16: exact in bf16
        Xn, yn = datasets.digits()
        provenance = "sklearn-digits"
    else:
        Xn, yn = datasets.mnist(args.data)
        provenance = datasets.mnist_provenance(args.data)
    X, yi, y = _labelled(Xn, yn, NUM_CLASSES, dev)
    model = Softmax(dim=X.shape[1], n_classes=NUM_CLASSES, alpha=args.alpha)
    gen = streams.block_generator(args.seed, dev, chain_block(layout, args.chains))

    setup_s, setup_cached = 0.0, False
    if args.diag_mass:
        # plain diagonal-mass NUTS (escape hatch; does not mix at MNIST scale:
        # the posterior's conditioning spans ~6 orders of magnitude)
        metric, adapt_mass = None, True
        positions = init_chain_positions(model.init_params, args.chains, generator=gen,
                                         device=dev)
    else:
        # Kronecker Gauss-Newton metric + Newton MAP; no setup cache (every
        # stage takes well under a second on the card)
        t0 = time.perf_counter()
        metric, _, qmap, setup_cached = shared_gn_setup(
            X, y, model, alpha=args.alpha, layout=layout, newton_steps=60, cache_dir=None,
            provenance=provenance, seed=args.seed)
        adapt_mass = False
        if args.per_chain_nuts:
            # Laplace chain init in parameter space (the batched path draws
            # its own e ~ N(0, I) whitened init, the identical distribution)
            eps = streams.randn((args.chains,) + tuple(metric.d_aug.shape), generator=gen,
                                device=dev)
            positions = metric.sample_position({k: v[None] for k, v in qmap.items()}, eps)
        setup_s = time.perf_counter() - t0

    if metric is not None and not args.per_chain_nuts:
        # the default: lockstep chain-batched NUTS on the fused value+grad,
        # one pass over the data per leaf for all chains
        out = _run_mnist_nuts_batched(args, model, metric, qmap, X, y, gen, layout,
                                      draw_buffer_threshold)
        if out is None:                      # a rank other than 0
            return None
        run_s, extra, dev_res = out
        pm, pp, agg = dev_res["pm"], dev_res["pp"], dev_res["agg"]
        agg["diag_s"] = round(dev_res["diag_s"], 2)
    else:
        # the per-chain kernel on the plain (autograd) value+grad, never the
        # fused kernel: the slow cross-check of the default path
        logdensity = model.make_logdensity(batch=(X, y))
        kernel = nuts.build_kernel(logdensity, max_tree_depth=args.max_depth, metric=metric)
        draws, streamed, run_s = _run_chains(args, lambda p: nuts.init(p, logdensity), kernel,
                                             positions, gen, adapt_mass=adapt_mass)
        extra = {"sampler": "per-chain-nuts"}
        pm = {k: v.mean(dim=(0, 1)) for k, v in draws.items()}
        pp = posterior_predictive_probs(lambda p, x: model.predict(p, x, prob=True), draws, X,
                                        max_draws=32)
        agg = _save_and_summarize(args, draws, run_s, already_saved=streamed)
    acc = float((model.predict(pm, X) == yi).to(torch.float32).mean())
    cal = calibration_report(pp, yi)
    agg["run_s"] = round(run_s, 2)
    agg.update(extra)
    agg.update({"workload": "mnist-nuts", "train_accuracy": acc,
                "metric": "diag" if args.diag_mass else "kron-gauss-newton",
                "setup_s": round(setup_s, 2),
                "setup_from_cache": setup_cached,
                "dataset": provenance,
                "predictive_accuracy": cal["accuracy"],
                "predictive_ece": round(cal["ece"], 4),
                "predictive_nll": round(cal["nll"], 4),
                "device": _device_name(dev)})
    print(json.dumps(agg), flush=True)
    return agg


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(int(seed))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _labelled(Xn, yn, n_classes: int, dev: torch.device):
    """(X, integer labels, one-hot labels) on the device."""
    X = torch.from_numpy(Xn).to(dev)
    yi = torch.from_numpy(yn.astype(np.int64)).to(dev)
    return X, yi, torch.nn.functional.one_hot(yi, n_classes).to(torch.float32)


def _accuracy(pred: torch.Tensor, yi: torch.Tensor) -> float:
    return float((pred == yi).to(torch.float32).mean())


def cmd_mnist_mlp_sgmcmc(args) -> dict:
    from .diagnostics import calibration_report, posterior_predictive_probs, summarize
    from .inference import sgd as sgd_mod
    from .inference import sgmcmc
    from .io import datasets
    from .models import DropoutMLP
    from .ops.tree import tree_randn_like

    dev, layout = _join(args, "--data-shards", num_data_shards=args.data_shards)
    sharded = layout.distributed
    X, yi, y = _labelled(*datasets.mnist(args.data), NUM_CLASSES, dev)
    n = X.shape[0]
    model = DropoutMLP(dim=X.shape[1], hidden=args.hidden, n_classes=NUM_CLASSES,
                       alpha=args.alpha, p_drop=args.p_drop)
    # the SAMPLED potential is the dropout log posterior: per-step Bernoulli
    # masks, one set per chain and gradient, go through the keyed log density
    dropout = args.p_drop > 0.0
    logdensity = model.make_batched_logdensity(data_size=n, dropout=dropout)

    params0 = {k: v[None] for k, v in model.init_params(_generator(dev, args.seed), dev).items()}
    sgd_s = 0.0
    if args.sgd_init_steps > 0 and layout.rank == 0:
        # warm start at an SGD mode: SG-MCMC burn-in from a cold Glorot init
        # would need O(1e5) steps just to travel to the typical set
        sgd_kernel = sgd_mod.build_sgd_kernel(model.make_batched_logdensity(data_size=n))
        t0 = time.perf_counter()
        sgd_state, _ = sgd_mod.fit(sgd_kernel, sgd_mod.sgd_init(params0), (X, y),
                                   batch_size=args.batch_size, num_steps=args.sgd_init_steps,
                                   step_size=args.sgd_step_size,
                                   generator=_generator(dev, args.seed + 2))
        _sync(dev)
        sgd_s = time.perf_counter() - t0
        params0 = sgd_state.position
    if sharded:
        # rank 0's warm start, on every rank
        from .parallel.mesh import broadcast_object

        got = broadcast_object(({k: v.cpu().numpy() for k, v in params0.items()}, sgd_s))
        params0 = {k: torch.from_numpy(v).to(dev) for k, v in got[0].items()}
        sgd_s = got[1]

    # chains are the leading axis, with jittered starts around the SGD mode,
    # so that split R-hat and ESS are computable over the MLP draws; a rank of
    # a sharded run keeps its chain block
    chains = args.chains
    block = chain_block(layout, chains)
    positions0 = {k: v.expand((chains,) + v.shape[1:]) for k, v in params0.items()}
    jitter = tree_randn_like(positions0, _generator(dev, args.seed + 4))
    positions0 = {k: (v + args.chain_jitter * jitter[k])[block.start:block.stop]
                  for k, v in positions0.items()}

    if sharded:
        # the value and gradient summed over the data shards of the chain block
        from .parallel import make_sharded_value_and_grad

        source = dict(value_and_grad_fn=make_sharded_value_and_grad(model, n, layout,
                                                                     keyed=dropout))
    else:
        source = dict(logdensity_fn=logdensity)
    if args.algorithm == "sghmc":
        kernel = sgmcmc.build_sghmc_kernel(friction=args.friction, keyed=dropout, **source)
        states = sgmcmc.sghmc_init(positions0)
    else:
        kernel = sgmcmc.build_sgld_kernel(keyed=dropout, **source)
        states = sgmcmc.sgld_init(positions0)

    t0 = time.perf_counter()
    schedule = sgmcmc.constant_schedule(args.step_size)
    if sharded:
        from .parallel import run_sgmcmc_data_parallel

        _, positions, infos = run_sgmcmc_data_parallel(
            kernel, states, chains, (X, y), layout, batch_size=args.batch_size,
            num_steps=args.num_steps, step_size_schedule=schedule,
            collect_every=args.collect_every, burnin_steps=args.burnin_steps,
            generator=streams.block_generator(args.seed + 1, dev, block))
        _sync(dev)
        elapsed = time.perf_counter() - t0
        gathered = gather((positions, infos), layout)
        if layout.rank != 0:
            return None
        positions, infos = gathered
    else:
        _, positions, infos = sgmcmc.run_sgmcmc_chains(
            kernel, states, chains, (X, y), batch_size=args.batch_size,
            num_steps=args.num_steps, step_size_schedule=schedule,
            collect_every=args.collect_every, burnin_steps=args.burnin_steps,
            generator=_generator(dev, args.seed + 1))
        _sync(dev)
        elapsed = time.perf_counter() - t0

    # Mixing over the (chains, draws, ...) MLP draws.  Weight-space R-hat on a
    # deep net is ill-posed by construction (hidden-unit permutation symmetry:
    # chains sample equivalent, differently labelled modes), so two
    # function-space traces are reported beside it: the minibatch log density
    # and the class probabilities on a fixed probe batch of 64 rows, which are
    # identified functionals of the network.  summarize() takes the ESS in
    # blocks over the parameter axis, so its FFT buffers stay bounded.
    mix = {k: float(v) for k, v in summarize(positions)["aggregate"].items()}
    fs = summarize({"logdensity": infos.logdensity})["aggregate"]
    probe = X[torch.linspace(0, n - 1, 64).to(torch.int64)]
    draws = positions["W1"].shape[1]
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in positions.items()}
    probe_probs = model.predict(flat, probe, prob=True).reshape(chains, draws, 64, NUM_CLASSES)
    pt = summarize({"probe_probs": probe_probs})["aggregate"]

    pm = {k: v.mean(dim=(0, 1)) for k, v in positions.items()}
    acc = _accuracy(model.predict(pm, X), yi)
    pp = posterior_predictive_probs(lambda p, x: model.predict(p, x, prob=True), positions, X,
                                    max_draws=32)
    cal = calibration_report(pp, yi)
    mc_acc = None
    if dropout:
        # MC-dropout predictive: 16 fresh-mask stochastic forwards at the
        # posterior mean, averaged
        gen = _generator(dev, args.seed + 3)
        mcp = sum(model.predict_stochastic(pm, X, generator=gen, prob=True)
                  for _ in range(16)) / 16
        mc_acc = _accuracy(mcp.argmax(dim=-1), yi)

    agg = {
        "workload": f"mnist-mlp-{args.algorithm}",
        "dataset": datasets.mnist_provenance(args.data),
        "dropout": dropout,
        "p_drop": args.p_drop,
        "chains": chains,
        "data_shards": args.data_shards,
        "mc_dropout_accuracy": mc_acc,
        "train_accuracy": acc,
        "predictive_accuracy": cal["accuracy"],
        "predictive_ece": round(cal["ece"], 4),
        "predictive_nll": round(cal["nll"], 4),
        "min_ess": round(mix["min_ess"], 1),
        "median_ess": round(mix["median_ess"], 1),
        "max_rhat": round(mix["max_rhat"], 4),
        "logdensity_ess": round(float(fs["min_ess"]), 1),
        "logdensity_rhat": round(float(fs["max_rhat"]), 4),
        "predictive_trace_min_ess": round(float(pt["min_ess"]), 1),
        "predictive_trace_median_ess": round(float(pt["median_ess"]), 1),
        "predictive_trace_max_rhat": round(float(pt["max_rhat"]), 4),
        "sgd_init_steps": args.sgd_init_steps,
        "sgd_init_s": round(sgd_s, 2),
        "elapsed_s": round(elapsed, 2),
        "steps_per_sec": round(chains * args.num_steps / elapsed, 1),
        "device": _device_name(dev),
    }
    print(json.dumps(agg), flush=True)
    return agg


def cmd_mnist_vi(args) -> dict:
    """Mean-field ADVI baseline on the MNIST softmax / MLP posterior, with
    the JSON schema of configs 3 and 4 (accuracy / ECE / NLL over
    posterior-predictive draws), so the comparison with the samplers is
    direct."""
    from .diagnostics import calibration_report, posterior_predictive_probs
    from .inference import vi
    from .io import datasets
    from .models import DropoutMLP, Softmax

    dev = _device(args)
    if args.dataset == "digits":
        Xn, yn = datasets.digits()
        provenance = "sklearn-digits"
    else:
        Xn, yn = datasets.mnist(args.data)
        provenance = datasets.mnist_provenance(args.data)
    X, yi, y = _labelled(Xn, yn, NUM_CLASSES, dev)
    n = X.shape[0]

    if args.model == "mlp":
        model = DropoutMLP(dim=X.shape[1], hidden=args.hidden, n_classes=NUM_CLASSES,
                           alpha=args.alpha, p_drop=0.0)
    else:
        model = Softmax(dim=X.shape[1], n_classes=NUM_CLASSES, alpha=args.alpha)
    kernel = vi.build_kernel(model.make_batched_logdensity(data_size=n),
                             num_mc_samples=args.mc_samples, learning_rate=args.learning_rate)
    # init_log_std: for deep nets start q nearly deterministic (e.g. -6); the
    # default's 0.05 posterior noise through a 256-wide net swamps the
    # likelihood gradient and ADVI collapses the means to the prior mode
    state = vi.init(model.init_params(_generator(dev, args.seed), dev),
                    initial_log_std=args.init_log_std)

    t0 = time.perf_counter()
    state, losses = vi.fit(kernel, state, (X, y), args.batch_size, args.num_steps,
                           generator=_generator(dev, args.seed + 1))
    _sync(dev)
    elapsed = time.perf_counter() - t0

    draws = vi.sample_from(state, args.posterior_draws, generator=_generator(dev, args.seed + 2))
    pp = posterior_predictive_probs(lambda p, x: model.predict(p, x, prob=True),
                                    {k: v[None] for k, v in draws.items()}, X,
                                    max_draws=args.posterior_draws)
    cal = calibration_report(pp, yi)
    neg_elbo = losses.double().cpu().numpy()
    agg = {
        "workload": f"mnist-vi-{args.model}",
        "dataset": provenance,
        "train_accuracy": _accuracy(model.predict(state.mu, X), yi),
        "predictive_accuracy": cal["accuracy"],
        "predictive_ece": round(cal["ece"], 4),
        "predictive_nll": round(cal["nll"], 4),
        "elbo_first_last": [round(float(-neg_elbo[:50].mean()), 1),
                            round(float(-neg_elbo[-50:].mean()), 1)],
        "num_steps": args.num_steps,
        "elapsed_s": round(elapsed, 2),
        "steps_per_sec": round(args.num_steps / elapsed, 1),
        "device": _device_name(dev),
    }
    print(json.dumps(agg), flush=True)
    return agg


def cmd_plantvillage_smc(args) -> dict:
    from .diagnostics import calibration_report, posterior_predictive_probs
    from .inference import hmc, smc
    from .inference.sampling import init_chain_positions
    from .io import datasets
    from .models import Softmax

    if args.shard_particles:
        # the particle axis over every rank of the torchrun group (one rank
        # alone holds them all)
        dev, layout = _join(args, "--shard-particles")
    else:
        dev, layout = _device(args), RankLayout(1, 1, 0)
    block = chain_block(layout, args.particles)
    Xn, yn = datasets.plantvillage_features(args.data, n=args.n_data)
    k = int(yn.max()) + 1
    X, yi, y = _labelled(Xn, yn, k, dev)
    model = Softmax(dim=X.shape[1], n_classes=k, alpha=args.alpha)

    # the model broadcasts over the particle axis: every particle's density
    # comes from one GEMM on the shared data
    def log_prior(p):
        return model.log_prior(p)

    def log_lik(p):
        return model.log_likelihood(p, (X, y))

    def log_lik_batch(p, b):
        return model.log_likelihood(p, b)

    for fn in (log_prior, log_lik, log_lik_batch):
        fn.chain_batched = True

    particles = init_chain_positions(model.init_params, block.size,
                                     generator=streams.block_generator(args.seed, dev, block),
                                     device=dev)
    smc_kwargs = dict(
        kernel_builder=lambda ld: hmc.build_kernel(ld, args.num_steps),
        init_builder=lambda ld: (lambda p: hmc.init(p, ld)),
        step_size=args.step_size, num_mcmc_steps=args.mcmc_steps,
    )
    if args.mutation == "sghmc":
        smc_kwargs.update(mutation="sghmc", log_likelihood_batch_fn=log_lik_batch,
                          data=(X, y), batch_size=args.batch_size)

    t0 = time.perf_counter()
    state, info = smc.run_tempered_smc(
        particles, log_prior, log_lik, **smc_kwargs,
        generator=streams.block_generator(args.seed + 1, dev, block),
        layout=layout if layout.distributed else None)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    state = state._replace(particles=gather(state.particles, layout))
    if layout.rank != 0:
        return None

    pm = {kk: v.mean(dim=0) for kk, v in state.particles.items()}
    pp = posterior_predictive_probs(lambda p, x: model.predict(p, x, prob=True),
                                    {kk: v[None] for kk, v in state.particles.items()}, X,
                                    max_draws=32)
    cal = calibration_report(pp, yi)
    sa = info.stage_acceptance.cpu().numpy()
    sa = sa[~np.isnan(sa)]
    ss = info.stage_step_size.cpu().numpy()
    ss = ss[~np.isnan(ss)]
    agg = {
        "workload": "plantvillage-smc",
        "mutation": args.mutation,
        "shard_particles": bool(args.shard_particles),
        "dataset": datasets.plantvillage_provenance(args.data),
        "predictive_accuracy": cal["accuracy"],
        "predictive_ece": round(cal["ece"], 4),
        "train_accuracy": _accuracy(model.predict(pm, X), yi),
        "num_stages": int(info.num_stages),
        "log_evidence": float(state.log_evidence),
        "stage_acceptance_min": round(float(sa.min()), 4) if sa.size else None,
        "stage_acceptance_max": round(float(sa.max()), 4) if sa.size else None,
        "step_size_first_last": [round(float(ss[0]), 6),
                                 round(float(ss[-1]), 6)] if ss.size else None,
        "elapsed_s": round(elapsed, 2),
        "device": _device_name(dev),
    }
    print(json.dumps(agg), flush=True)
    return agg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dhmc-torch",
                                     description="PyTorch/CUDA Bayesian MCMC workloads")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mvn-hmc")
    _common(p)
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--num-steps", type=int, default=16)
    p.add_argument("--nuts", action="store_true")
    p.set_defaults(fn=cmd_mvn_hmc)

    p = sub.add_parser("logistic-hmc")
    _common(p)
    p.add_argument("--n-data", type=int, default=1000)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--num-steps", type=int, default=16)
    p.set_defaults(fn=cmd_logistic_hmc, chains=32)

    p = sub.add_parser("mnist-nuts")
    _common(p)
    p.add_argument("--data", type=str, default=None,
                   help="an MNIST HDF5 file (X_train / y_train); without one the "
                        "synthetic set is used")
    p.add_argument("--dataset", choices=["auto", "digits"], default="auto",
                   help="'digits' = scikit-learn's real 8x8 pixels (1797 x 64) "
                        "instead of the synthetic MNIST")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--max-depth", type=int, default=6)
    p.add_argument("--diag-mass", action="store_true",
                   help="disable the Kronecker Gauss-Newton metric (plain "
                        "diagonal-mass NUTS with Welford mass adaptation; will not "
                        "mix at MNIST scale)")
    p.add_argument("--target-accept", type=float, default=0.65,
                   help="warmup acceptance target.  0.65 is robust across datasets; "
                        "on the MNIST-scale whitened posterior 0.5 is the ESS/s "
                        "optimum, but on sklearn-digits 0.5 halves min ESS")
    p.add_argument("--chain-shards", type=int, default=1,
                   help=">1: lay the chains over this many ranks, one process each, under "
                        "torchrun (--nproc-per-node N); must divide --chains.  Each rank "
                        "warms up and samples its block on a stream that carries the block, "
                        "and no shard index enters any stream, so the adapted step sizes and "
                        "the draws do not depend on the shard count beyond the rounding of "
                        "block-sized products: they are those of the same blocks run in one "
                        "process, bit for bit")
    _dist_backend(p)
    p.add_argument("--per-chain-nuts", action="store_true",
                   help="use the per-chain NUTS kernel on the plain value+grad "
                        "instead of the default lockstep chain-batched kernel on "
                        "the fused one (much slower per draw at MNIST scale; "
                        "escape hatch / cross-check)")
    p.set_defaults(fn=cmd_mnist_nuts)

    p = sub.add_parser("mnist-mlp-sgmcmc")
    p.add_argument("--data", type=str, default=None,
                   help="an MNIST HDF5 file (X_train / y_train); without one the "
                        "synthetic set is used")
    p.add_argument("--algorithm", choices=["sgld", "sghmc"], default="sghmc")
    p.add_argument("--chains", type=int, default=16,
                   help="SG-MCMC chains, advanced together (jittered starts around the "
                        "SGD mode; enables ESS / split-R-hat diagnostics)")
    p.add_argument("--chain-jitter", type=float, default=0.02)
    p.add_argument("--data-shards", type=int, default=1,
                   help=">1: under torchrun, split the rows over this many ranks per chain "
                        "block (ranks / N chain blocks); each gathers batch-size / N local "
                        "rows a step and the gradients are summed over the block's ranks")
    _dist_backend(p)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--p-drop", type=float, default=0.1)
    p.add_argument("--friction", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-steps", type=int, default=3000)
    p.add_argument("--burnin-steps", type=int, default=1000)
    p.add_argument("--collect-every", type=int, default=10)
    p.add_argument("--step-size", type=float, default=1e-5)
    p.add_argument("--sgd-init-steps", type=int, default=3000,
                   help="SGD warm-start steps before sampling; 0 = cold")
    p.add_argument("--sgd-step-size", type=float, default=2e-7,
                   help="SGD step on the n-scaled log density: the effective rate on "
                        "the mean loss is step*n/(1-gamma) ~ 0.12 at the defaults")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    p.set_defaults(fn=cmd_mnist_mlp_sgmcmc)

    p = sub.add_parser("mnist-vi")
    p.add_argument("--data", type=str, default=None,
                   help="an MNIST HDF5 file (X_train / y_train); without one the "
                        "synthetic set is used")
    p.add_argument("--dataset", choices=["auto", "digits"], default="auto")
    p.add_argument("--model", choices=["softmax", "mlp"], default="softmax")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-steps", type=int, default=3000)
    p.add_argument("--mc-samples", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--posterior-draws", type=int, default=32)
    p.add_argument("--init-log-std", type=float, default=-3.0,
                   help="initial log std of q (use ~-6 for the MLP: large initial "
                        "posterior noise collapses ADVI on deep nets)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    p.set_defaults(fn=cmd_mnist_vi)

    p = sub.add_parser("plantvillage-smc")
    p.add_argument("--data", type=str, default=None,
                   help="a conv-feature HDF5 file (features / labels); without one the "
                        "synthetic set is used")
    p.add_argument("--n-data", type=int, default=5000)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--particles", type=int, default=128)
    p.add_argument("--num-steps", type=int, default=8)
    p.add_argument("--mcmc-steps", type=int, default=3)
    p.add_argument("--step-size", type=float, default=1e-3)
    p.add_argument("--mutation", choices=["hmc", "sghmc"], default="hmc",
                   help="sghmc: minibatch SGHMC mutation on the tempered potential")
    p.add_argument("--batch-size", type=int, default=512,
                   help="minibatch size for --mutation sghmc")
    p.add_argument("--shard-particles", action="store_true",
                   help="lay the particles over the ranks of the torchrun group (each "
                        "mutates its block; the ladder and the resampler run on the "
                        "all-gathered weights)")
    _dist_backend(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when named)")
    p.set_defaults(fn=cmd_plantvillage_smc)

    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
