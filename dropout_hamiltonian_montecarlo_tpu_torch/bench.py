"""Headline benchmark of the port: effective samples/s on the MNIST softmax
posterior, with chain-batched HMC on one GPU.

    python -m dropout_hamiltonian_montecarlo_tpu_torch.bench [--device cuda]

Pipeline (the JAX package's bench.py, same settings):
  1. data: synthetic MNIST 60000 x 784 on the 8-bit grid (BENCH_DATASET=digits:
     scikit-learn's real 8x8 digits);
  2. exact Kronecker Gauss-Newton metric, Newton MAP, class Fisher at the MAP
     (ops.kron_metric.cached_gn_setup);
  3. the sampler in whitened coordinates e = M^{1/2} (q - q_map), BENCH_CHAINS
     chains:
     - BENCH_SAMPLER=hmc (default): fixed L (BENCH_L), lazy-value
       trajectories: L-1 grad-only calls of the fused softmax-GLM kernel and
       one accurate value+grad call per draw;
     - BENCH_SAMPLER=nuts: lockstep chain-batched NUTS, one accurate
       value+grad call per lockstep leaf (the multinomial weights need the
       value at every leaf).  BENCH_NUTS_DEPTH caps the doubling (default 4:
       at most 15 leaves), or "auto": warm up at cap 6, take the cap whose
       tree size is nearest the median leaves of the last 100 warmup steps
       (times 0.55 above target 0.55), then refine the step for
       min(100, BENCH_WARMUP) steps on the capped kernel;
  4. per-chain dual-averaging warmup (BENCH_WARMUP steps, target
     BENCH_TARGET_ACCEPT), no mass adaptation; or, for HMC, BENCH_CHEES=1:
     ChEES adapts one shared (step size, trajectory length) and sets L;
  5. an exact Gibbs move on the softmax gauge subspace after every draw;
  6. draws mapped back to parameter space and FFT ESS per coordinate.

BENCH_KERNEL=0 runs the plain PyTorch value+grad in place of the fused kernel
(one bench A/B of kernel against plain; the line then says "kernel": "plain").
BENCH_TRACE=DIR wraps the sampling loop in a torch.profiler span, with the
program's spans on, and writes DIR/trace.json (utils.profiling.device_trace;
DIR/rank<r>/trace.json for each rank under BENCH_CHAIN_SHARDS).

BENCH_CHAIN_SHARDS=N lays the chains over N ranks, one process each, started
by torchrun:

    BENCH_CHAIN_SHARDS=2 torchrun --standalone --nproc-per-node 2 \
        -m dropout_hamiltonian_montecarlo_tpu_torch.bench [--dist-backend gloo]

Rank 0 computes the metric setup and sends it to the others; each rank warms
up and samples its block of BENCH_CHAINS / N chains through the fused kernel,
with the gauge Gibbs move after every draw, on a generator that carries its
block, so its draws are the one-process run's rows whatever N is.  Rank 0
gathers the draws, computes ESS over all chains and alone prints the line
(``detail.chain_shards``; ``sample_seconds`` the slowest rank's).  NCCL takes
one card per rank: two ranks on one card need ``--dist-backend gloo``.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"device", "detail"}; value = median ESS/s over all parameter coordinates
(sampling seconds only; setup and warmup are reported apart).  The default
device is cuda and the run fails without a card; ``--device cpu`` must be
asked for by name.  Unlike the JAX bench the sampling loop runs once: there
is no compile run to discard.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

ALPHA = 1.0
NUM_CLASSES = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(*, device, chains: int = 128, warmup: int = 300, draws: int = 1000,
        num_integration_steps: int = 10, target_accept: float = 0.5,
        dataset: str = "mnist", seed: int = 1, sampler: str = "hmc",
        nuts_depth=4, chees: bool = False, use_kernel: bool = True,
        trace_dir=None, layout=None, keep_draws: bool = False):
    """Run the whole headline pipeline on ``device``; returns the JSON record.

    ``sampler`` is "hmc" or "nuts"; ``nuts_depth`` an int cap or "auto";
    ``chees`` tunes HMC's L (ignored under NUTS, as in the JAX bench);
    ``use_kernel=False`` runs the plain PyTorch value+grad in place of the
    fused kernel; ``trace_dir`` profiles the sampling loop into that folder
    (this process's loop under a layout).

    ``layout`` (``parallel.RankLayout``): this rank's chain block of
    ``chains``.  With process groups the record is rank 0's, over all chains,
    and the other ranks return None.  A layout without groups runs the block
    alone in this process, and its record covers the block.  ChEES adapts one
    (step, L) from every chain, so under a layout each rank runs its warmup
    on all chains, as the JAX bench warms up before it shards.

    ``keep_draws``: the record also holds ``"draws"``: the parameter-space
    draws {"weights", "bias"} (chains, draws, ...) and the accept decisions
    (chains, draws), for checks that compare runs."""
    from . import full_f32_precision
    from .diagnostics.ess import effective_sample_size
    from .inference import hmc, nuts_batched
    from .inference.chees import run_chees_warmup
    from .inference.warmup import run_warmup
    from .io import datasets
    from .models import Softmax
    from .ops.kron_metric import (make_whitened_fused_vag, make_whitened_gauge_gibbs,
                                  shared_gn_setup)
    from .ops import streams
    from .ops.softmax_glm import launch_counts
    from .ops.tree import tree_ones_like
    from .parallel.chains import sample_batched_sharded
    from .parallel.mesh import RankLayout, all_gather_cat, chain_block, gather
    from .utils.profiling import SamplerStats, device_trace

    full_f32_precision()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    t_setup0 = time.perf_counter()
    if dataset == "digits":
        provenance = "sklearn-digits"
        Xn, yn = datasets.digits()
    else:
        provenance = datasets.mnist_provenance()
        Xn, yn = datasets.mnist()
    t_data = time.perf_counter() - t_setup0
    X = torch.from_numpy(Xn).to(dev)
    yi = torch.from_numpy(yn.astype(np.int64)).to(dev)
    y = torch.nn.functional.one_hot(yi, NUM_CLASSES).to(torch.float32)
    d = int(X.shape[1])
    model = Softmax(dim=d, n_classes=NUM_CLASSES, alpha=ALPHA)
    log(f"data: {tuple(X.shape)} ({t_data:.1f}s); params={d * 10 + 10} "
        f"chains={chains} device={device_name}")

    # no setup cache: every stage takes well under a second on the card
    metric, aux, qmap, _ = shared_gn_setup(X, y, model, alpha=ALPHA, layout=layout,
                                           newton_steps=60, cache_dir=None)
    map_acc = float((model.predict(qmap, X) == yi).float().mean())
    _sync(dev)
    t_setup = time.perf_counter() - t_setup0
    log(f"metric setup: {t_setup:.1f}s {aux['timings']}; MAP train acc {map_acc:.4f}")

    if sampler not in ("hmc", "nuts"):
        raise ValueError(f"sampler must be 'hmc' or 'nuts', got {sampler!r}")
    use_nuts = sampler == "nuts"
    nuts_auto = use_nuts and nuts_depth == "auto"
    use_chees = chees and not use_nuts          # ChEES tunes HMC's trajectory
    gauge_gibbs = make_whitened_gauge_gibbs(metric, aux, qmap)
    batched_vag, batched_grad = make_whitened_fused_vag(model, metric, qmap, (X, y),
                                                        use_kernel=use_kernel)
    block = chain_block(layout, chains) if layout is not None else None
    gen = streams.block_generator(seed, dev, block)
    init = nuts_batched.batched_init if use_nuts else hmc.batched_init
    c = block.size if block is not None else chains      # this process's chains

    def rows(state):
        return state if block is None else type(state)(*(
            {k: v[block.start:block.stop] for k, v in f.items()} if isinstance(f, dict)
            else f[block.start:block.stop] for f in state))

    # Laplace init is exactly e ~ N(0, I) in whitened coordinates; ChEES draws
    # it for all chains (the generator advances alike either way)
    gen.block = None if use_chees else block
    n0 = chains if use_chees else c
    e0 = {"weights": streams.randn((n0, d, NUM_CLASSES), generator=gen, device=dev),
          "bias": streams.randn((n0, NUM_CLASSES), generator=gen, device=dev)}
    t0 = time.perf_counter()
    nuts_kernels = []
    if use_chees:
        # one shared (step size, trajectory length) from all chains; sampling
        # then runs the lazy-value HMC kernel at the tuned L on the block
        cres = run_chees_warmup(batched_vag, hmc.batched_init(e0, batched_vag), warmup,
                                initial_step_size=0.1, target_acceptance=target_accept,
                                max_leapfrog_steps=64, generator=gen)
        gen.block = block
        num_integration_steps = max(cres.num_integration_steps, 1)
        warm_state = rows(cres.state)
        warm_step = torch.full((c,), float(cres.step_size), device=dev)
        warm_inv_mass = tree_ones_like(warm_state.position)
        log(f"ChEES warmup ({warmup} steps): eps={float(cres.step_size):.4f} "
            f"T={float(cres.trajectory_length):.3f} -> L={num_integration_steps}")
    else:
        if use_nuts:
            # an exploratory cap of 6 for "auto": trees stop at their natural U-turn
            nuts_cap = 6 if nuts_auto else int(nuts_depth)
            kernel = nuts_batched.build_batched_kernel(batched_vag, max_tree_depth=nuts_cap)
            nuts_kernels.append(kernel)
        else:
            kernel = hmc.build_batched_kernel(batched_vag, num_integration_steps,
                                              grad_fn=batched_grad)
        warm = run_warmup(kernel, init(e0, batched_vag), warmup,
                          initial_step_size=torch.full((c,), 0.1, device=dev),
                          target_acceptance=target_accept, adapt_mass=False,
                          generator=gen)
        warm_state, warm_step, warm_inv_mass = warm.state, warm.step_size, warm.inv_mass

    warmup_median_leaves = None
    if nuts_auto:
        # the sampling cap whose tree size is nearest the warmup's natural tree
        # size (the median leaves of its last 100 steps), truncated to 0.55 of
        # it above target 0.55, where trees overshoot the ESS/s optimum
        # over every chain: the blocks' last 100 steps, gathered
        leaves_w = all_gather_cat(warm.info[0].num_integration_steps[-100:],
                                  layout.chains_group if layout is not None else None,
                                  dim=1).cpu().numpy()
        warmup_median_leaves = float(np.median(leaves_w.astype(np.float64)))
        frac = 1.0 if target_accept <= 0.55 else 0.55
        target_leaves = max(frac * warmup_median_leaves, 3.0)
        nuts_cap = min(range(2, 7), key=lambda c: abs((2 ** c - 1) - target_leaves))
        log(f"auto depth cap: warmup median leaves {warmup_median_leaves:.0f} -> cap "
            f"{nuts_cap} ({2 ** nuts_cap - 1} leaves max)")
        kernel = nuts_batched.build_batched_kernel(batched_vag, max_tree_depth=nuts_cap)
        nuts_kernels.append(kernel)
        # a short dual-averaging refinement on the capped kernel: truncated
        # trees accept more at the same step, so the step re-adapts upward
        refine = run_warmup(kernel, warm_state, min(100, warmup),
                            initial_step_size=warm_step, target_acceptance=target_accept,
                            adapt_mass=False, generator=gen)
        warm_state, warm_step = refine.state, refine.step_size
    elif use_chees:
        kernel = hmc.build_batched_kernel(batched_vag, num_integration_steps,
                                          grad_fn=batched_grad)
    _sync(dev)
    t_warm = time.perf_counter() - t0
    ss = warm_step.cpu().numpy()
    log(f"warmup ({warmup} steps): {t_warm:.1f}s; step size median="
        f"{np.median(ss):.4f} min={ss.min():.4f} max={ss.max():.4f}")

    # the draws of this process's chains through the chain-block sampler, the
    # gauge Gibbs move after every draw; the sampling seconds stop before a
    # trace is written
    st = init(warm_state.position, batched_vag)
    leaves_before = kernel.leaves_executed if use_nuts else 0
    with device_trace(trace_dir) if trace_dir else contextlib.nullcontext():
        stats = SamplerStats(num_chains=c).start()
        _, e, infos = sample_batched_sharded(
            kernel, st, warm_step, warm_inv_mass, draws,
            layout if layout is not None else RankLayout(1), generator=gen,
            post_step=gauge_gibbs)
        _sync(dev)
        # grad evals: for NUTS the leaves the lockstep kernel executed (the
        # max over chains, plus any masked leaf a late flag read let
        # through); the per-chain tree sizes are reported apart
        executed = (kernel.leaves_executed - leaves_before if use_nuts
                    else draws * num_integration_steps)
        t_sample = stats.stop(draws=c * draws, grad_evals=c * executed).seconds
    launches = dict(launch_counts)
    e_w, e_b = e["weights"], e["bias"]
    accepted = infos.is_accepted if keep_draws else None
    acc_sum = infos.acceptance_prob.float().sum(1)
    div_sum = infos.is_divergent.float().sum(1)
    leaves_sum = infos.num_integration_steps.float().sum(1)

    # back to parameter space, one chain at a time, in place
    t0 = time.perf_counter()
    for i in range(c):
        dq = metric.unwhiten({"weights": e_w[i], "bias": e_b[i]})
        e_w[i] = qmap["weights"] + dq["weights"]
        e_b[i] = qmap["bias"] + dq["bias"]
    per_rank = None
    if layout is not None and layout.distributed:
        # rank 0 takes every block: the draws, the per-chain sums, and each
        # rank's sampling seconds and kernel launches
        mine = torch.tensor([[t_sample, launches["value_and_grad"], launches["grad"]]],
                            dtype=torch.float64, device=dev)
        got = gather({"w": e_w, "b": e_b, "accepted": accepted, "rank": mine}, layout)
        sums = gather(torch.stack([acc_sum, div_sum, leaves_sum, warm_step]), layout, dim=1)
        if got is None:
            return None
        e_w, e_b, accepted = got["w"], got["b"], got["accepted"]
        acc_sum, div_sum, leaves_sum, warm_step = sums.unbind(0)
        ss = warm_step.cpu().numpy()
        per_rank = got["rank"].cpu().numpy()
        t_sample = float(per_rank[:, 0].max())      # the slowest rank's
        c = chains
        stats.seconds, stats.draws, stats.grad_evals = t_sample, c * draws, c * executed
    mean_leaves = float(leaves_sum.sum()) / (c * draws)
    ess = torch.cat([effective_sample_size(e_w, block_size=512).reshape(-1),
                     effective_sample_size(e_b).reshape(-1)]).cpu().numpy()
    t_ess = time.perf_counter() - t0

    chains = c
    accept = float(acc_sum.sum()) / (chains * draws)
    div = float(div_sum.sum()) / (chains * draws)
    cap = chains * draws
    med_ess = float(np.median(ess))
    p10_ess = float(np.percentile(ess, 10))
    min_ess = float(np.min(ess))
    ess_per_sec = med_ess / t_sample
    log(f"sampling: {t_sample:.2f}s for {chains}x{draws} draws; accept={accept:.3f} "
        f"divergent={div:.4f}; ESS median={med_ess:.0f} p10={p10_ess:.0f} "
        f"min={min_ess:.0f} (cap {cap}); ESS/s median={ess_per_sec:.1f}")

    record = {
        "metric": "median_ess_per_sec_mnist_softmax_hmc",
        "value": ess_per_sec,
        "unit": "eff_samples/s/chip",
        "vs_baseline": ess_per_sec / 1000.0,
        "device": device_name,
        "detail": {
            "chains": chains,
            "draws": draws,
            "warmup_steps": warmup,
            "sample_seconds": t_sample,
            "ess_median": med_ess,
            "ess_p10": p10_ess,
            "ess_min": min_ess,
            "ess_cap_chains_x_draws": cap,
            "ess_median_frac_of_cap": med_ess / cap,
            "ess_min_frac_of_cap": min_ess / cap,
            "frac_coords_at_cap": float(np.mean(ess >= cap * 0.999)),
            "ess_per_sec_p10": p10_ess / t_sample,
            "ess_per_sec_min": min_ess / t_sample,
            "acceptance": accept,
            "divergent_frac": div,
            "step_size_median": float(np.median(ss)),
            "step_size_min": float(ss.min()),
            "step_size_max": float(ss.max()),
            "draws_per_sec": stats.draws_per_sec,
            "grad_evals_per_sec": stats.grads_per_sec,
            "amortized_setup_seconds": t_setup,
            "setup_breakdown_seconds": dict(aux["timings"], data=t_data),
            "map_train_accuracy": map_acc,
            "amortized_warmup_seconds": t_warm,
            "ess_seconds": t_ess,
            "path": ("torch-plain" if dev.type != "cuda" else
                     "cuda-kernel" if use_kernel else "cuda-plain"),
            "kernel": "cuda" if dev.type == "cuda" and use_kernel else "plain",
            "kernel_launches": launches,
            "chain_shards": layout.num_chain_shards if layout is not None else 1,
            "kernel_launches_per_rank": (
                None if per_rank is None else
                [{"value_and_grad": int(r[1]), "grad": int(r[2])} for r in per_rank]),
            "sample_seconds_per_rank": (None if per_rank is None
                                        else [float(r[0]) for r in per_rank]),
            "sampler": sampler,
            "nuts_depth_cap": nuts_cap if use_nuts else None,
            "nuts_depth_mode": ("auto" if nuts_auto else "fixed") if use_nuts else None,
            "warmup_median_leaves": warmup_median_leaves,
            "num_integration_steps": mean_leaves,
            "lockstep_evals_per_draw": executed / draws,
            "lockstep_leaves": (sum(k.leaves_executed for k in nuts_kernels)
                                if use_nuts else None),
            "target_accept": target_accept,
            "warmup": "chees" if use_chees else "dual-averaging",
            "chees_leapfrog_steps": sum(cres.info[3]) if use_chees else None,
            "dataset": provenance,
        },
    }
    if keep_draws:
        record["draws"] = {"weights": e_w, "bias": e_b, "accepted": accepted}
    return record


def main(argv=None, *, keep_draws: bool = False):
    """Parse ``argv`` and the BENCH_* variables, run, print the line; returns
    the record (None on ranks other than 0), with its ``"draws"`` when
    ``keep_draws`` (they are not printed)."""
    from .parallel import init_distributed, local_device, make_layout

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when named)")
    parser.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                        help="with BENCH_CHAIN_SHARDS: the collectives' backend (default "
                             "nccl on cuda, gloo on the CPU; two ranks on one card need gloo)")
    args = parser.parse_args(argv)

    shards = int(os.environ.get("BENCH_CHAIN_SHARDS", "1"))
    launched = "WORLD_SIZE" in os.environ
    layout, device = None, args.device
    if shards > 1 or launched:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != shards:
            raise SystemExit(
                f"BENCH_CHAIN_SHARDS={shards} runs one process per chain block, under torchrun "
                f"with as many ranks (WORLD_SIZE={os.environ.get('WORLD_SIZE')}): "
                f"BENCH_CHAIN_SHARDS={shards} torchrun --standalone --nproc-per-node {shards} "
                f"-m dropout_hamiltonian_montecarlo_tpu_torch.bench")
        device = local_device(args.device)
        init_distributed(backend=args.dist_backend, device=device)
        layout = make_layout(num_chain_shards=shards)
    depth = os.environ.get("BENCH_NUTS_DEPTH", "4")
    trace_dir = os.environ.get("BENCH_TRACE")
    if trace_dir and layout is not None and layout.world_size > 1:
        trace_dir = os.path.join(trace_dir, f"rank{layout.rank}")   # one trace a rank
    result = run(
        device=device,
        chains=int(os.environ.get("BENCH_CHAINS", "128")),
        warmup=int(os.environ.get("BENCH_WARMUP", "300")),
        draws=int(os.environ.get("BENCH_DRAWS", "1000")),
        num_integration_steps=int(os.environ.get("BENCH_L", "10")),
        target_accept=float(os.environ.get("BENCH_TARGET_ACCEPT", "0.5")),
        dataset=os.environ.get("BENCH_DATASET", "mnist"),
        sampler=os.environ.get("BENCH_SAMPLER", "hmc"),
        nuts_depth=("auto" if depth == "auto" else int(depth)),
        chees=os.environ.get("BENCH_CHEES", "0") == "1",
        use_kernel=os.environ.get("BENCH_KERNEL", "1") == "1",
        trace_dir=trace_dir,
        layout=layout,
        keep_draws=keep_draws,
    )
    if result is not None:
        print(json.dumps({k: v for k, v in result.items() if k != "draws"}))
    return result


if __name__ == "__main__":
    main()
