"""Command-line entry point of the port.

    python -m dropout_hamiltonian_montecarlo_tpu_torch.cli mnist-nuts [options]
    dhmc-torch mnist-nuts [options]

  mnist-nuts  config 3: MNIST softmax, full-batch lockstep chain-batched NUTS
              in the whitened Kronecker Gauss-Newton coordinates

Prints one JSON summary line with the keys of the JAX package's
``dhmc-tpu mnist-nuts`` (batched path) plus ``"device"``.  The default device
is cuda and the run fails without a card; ``--device cpu`` must be asked for
by name.  The other subcommands of the JAX CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

NUM_CLASSES = 10


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--step-size", type=float, default=0.1)
    p.add_argument("--save", type=str, default=None,
                   help="write posterior draws to this HDF5 file (not ported yet)")
    p.add_argument("--stream-chunk", type=int, default=0,
                   help="with --save: spool draws in chunks of this many (not ported yet)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="write a resumable checkpoint after every chunk (not ported yet)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when named)")


def _refuse_unported(args) -> None:
    """Options of the JAX CLI that the port does not run yet, each with its
    ROADMAP item."""
    unported = [
        (args.save is not None, "--save: HDF5 backends are not ported yet (ROADMAP slice 5)"),
        (args.stream_chunk > 0,
         "--stream-chunk: HDF5 spooling is not ported yet (ROADMAP slice 5)"),
        (args.checkpoint is not None or args.resume,
         "--checkpoint/--resume: checkpoints are not ported yet (ROADMAP slice 5)"),
        (args.chain_shards > 1, "--chain-shards > 1: chain sharding is not ported yet "
                                "(ROADMAP slice 5)"),
        (args.diag_mass, "--diag-mass: Welford mass adaptation is not ported yet "
                         "(ROADMAP slice 3)"),
        (args.per_chain_nuts, "--per-chain-nuts: the per-chain NUTS kernel is not ported "
                              "yet (ROADMAP slice 3)"),
        (args.data is not None, "--data PATH: the MNIST HDF5 reader is not ported yet "
                                "(ROADMAP slice 5)"),
    ]
    for refused, msg in unported:
        if refused:
            raise NotImplementedError(msg)


def _run_mnist_nuts_batched(args, model, metric, qmap, X, y, gen):
    """Config 3's execution path: lockstep chain-batched NUTS in whitened
    coordinates, every leaf of every chain's tree through ONE fused
    value+grad call, warmup by per-chain dual averaging on the same kernel,
    sampling in chunks with the draws kept on the device, and the
    diagnostics (blocked ESS, split R-hat, posterior mean, predictive
    probabilities) computed where the draws lie.

    Returns (run_s, extra, device_results)."""
    from .diagnostics.calibration import posterior_predictive_probs
    from .diagnostics.ess import effective_sample_size
    from .diagnostics.rhat import split_rhat
    from .diagnostics.summary import median
    from .inference import nuts_batched
    from .inference.sampling import DeviceBackend, sample_batched_streaming
    from .inference.warmup import run_warmup
    from .ops.kron_metric import make_whitened_fused_vag

    dev = X.device
    d, k, chains = X.shape[1], NUM_CLASSES, args.chains
    batched_vag, _ = make_whitened_fused_vag(model, metric, qmap, (X, y))
    kernel = nuts_batched.build_batched_kernel(batched_vag, max_tree_depth=args.max_depth)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    # Laplace init is exactly e ~ N(0, I) in whitened coordinates
    e0 = {"weights": torch.randn((chains, d, k), generator=gen, device=dev),
          "bias": torch.randn((chains, k), generator=gen, device=dev)}
    warm = run_warmup(kernel, nuts_batched.batched_init(e0, batched_vag), args.warmup,
                      initial_step_size=torch.full((chains,), args.step_size, device=dev),
                      target_acceptance=args.target_accept, adapt_mass=False,
                      generator=gen)
    sync()
    warm_s = time.perf_counter() - t0

    def to_param(pos_e):
        # whitened (C, T, ...) draws -> parameter space, one chain at a time
        out = {kk: torch.empty_like(v) for kk, v in pos_e.items()}
        for c in range(chains):
            dq = metric.unwhiten({kk: v[c] for kk, v in pos_e.items()})
            for kk in out:
                out[kk][c] = qmap[kk] + dq[kk]
        return out

    chunk = min(max(args.samples, 1), 50)
    backend = DeviceBackend()
    t0 = time.perf_counter()
    _, appended, infos = sample_batched_streaming(
        kernel, warm.state, warm.step_size, warm.inv_mass, backend,
        num_samples=args.samples, chunk_size=chunk, transform=to_param, generator=gen)
    sync()
    run_s = time.perf_counter() - t0
    extra = {"sampler": "batched-nuts", "warmup_s": round(warm_s, 2), "chain_shards": 1,
             "resumed": False,
             "draws_per_sec": round(chains * appended / max(run_s, 1e-9), 1)}

    # diagnostics where the draws live; only the (n, k) predictive
    # probabilities and a few scalars go to the host
    t1 = time.perf_counter()
    q = backend.draws()                                  # (C, T, ...)
    ess = torch.cat([effective_sample_size(q["weights"], block_size=512).reshape(-1),
                     effective_sample_size(q["bias"]).reshape(-1)])
    rh = torch.cat([split_rhat(q["weights"]).reshape(-1), split_rhat(q["bias"]).reshape(-1)])
    pm = {kk: v.mean(dim=(0, 1)) for kk, v in q.items()}
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
    return run_s, extra, {"agg": agg, "pm": pm, "pp": pp, "diag_s": diag_s}


def cmd_mnist_nuts(args) -> dict:
    from . import full_f32_precision
    from .diagnostics import calibration_report
    from .io import datasets
    from .models import Softmax
    from .ops.kron_metric import cached_gn_setup

    _refuse_unported(args)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    full_f32_precision()

    if args.dataset == "digits":
        # real bundled pixels (scikit-learn's 8x8 digits), k/16: exact in bf16
        Xn, yn = datasets.digits()
        provenance = "sklearn-digits"
    else:
        Xn, yn = datasets.mnist()
        provenance = datasets.mnist_provenance()
    X = torch.from_numpy(Xn).to(dev)
    yi = torch.from_numpy(yn.astype(np.int64)).to(dev)
    y = torch.nn.functional.one_hot(yi, NUM_CLASSES).to(torch.float32)
    model = Softmax(dim=X.shape[1], n_classes=NUM_CLASSES, alpha=args.alpha)
    gen = torch.Generator(device=dev).manual_seed(int(args.seed))

    # Kronecker Gauss-Newton metric + Newton MAP; no setup cache (every stage
    # takes well under a second on the card)
    t0 = time.perf_counter()
    metric, _, qmap, setup_cached = cached_gn_setup(
        X, y, model, alpha=args.alpha, newton_steps=60, cache_dir=None,
        provenance=provenance, seed=args.seed)
    setup_s = time.perf_counter() - t0

    run_s, extra, dev_res = _run_mnist_nuts_batched(args, model, metric, qmap, X, y, gen)
    acc = float((model.predict(dev_res["pm"], X) == yi).to(torch.float32).mean())
    cal = calibration_report(dev_res["pp"], yi)
    agg = dev_res["agg"]
    agg["diag_s"] = round(dev_res["diag_s"], 2)
    agg["run_s"] = round(run_s, 2)
    agg.update(extra)
    agg.update({"workload": "mnist-nuts", "train_accuracy": acc,
                "metric": "kron-gauss-newton",
                "setup_s": round(setup_s, 2),
                "setup_from_cache": setup_cached,
                "dataset": provenance,
                "predictive_accuracy": cal["accuracy"],
                "predictive_ece": round(cal["ece"], 4),
                "predictive_nll": round(cal["nll"], 4),
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"})
    print(json.dumps(agg), flush=True)
    return agg


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dhmc-torch",
                                     description="PyTorch/CUDA Bayesian MCMC workloads")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mnist-nuts")
    _common(p)
    p.add_argument("--data", type=str, default=None,
                   help="an MNIST HDF5 file (not ported yet: the synthetic set is used)")
    p.add_argument("--dataset", choices=["auto", "digits"], default="auto",
                   help="'digits' = scikit-learn's real 8x8 pixels (1797 x 64) "
                        "instead of the synthetic MNIST")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--max-depth", type=int, default=6)
    p.add_argument("--diag-mass", action="store_true",
                   help="plain diagonal-mass NUTS (not ported yet)")
    p.add_argument("--target-accept", type=float, default=0.65,
                   help="warmup acceptance target.  0.65 is robust across datasets; "
                        "on the MNIST-scale whitened posterior 0.5 is the ESS/s "
                        "optimum, but on sklearn-digits 0.5 halves min ESS")
    p.add_argument("--chain-shards", type=int, default=1,
                   help=">1: lay the chain axis across devices (not ported yet)")
    p.add_argument("--per-chain-nuts", action="store_true",
                   help="the per-chain NUTS kernel (not ported yet)")
    p.set_defaults(fn=cmd_mnist_nuts)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
