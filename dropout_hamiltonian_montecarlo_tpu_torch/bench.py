"""Headline benchmark of the port: effective samples/s on the MNIST softmax
posterior, with chain-batched HMC on one GPU.

    python -m dropout_hamiltonian_montecarlo_tpu_torch.bench [--device cuda]

Pipeline (the JAX package's bench.py, same settings):
  1. data: synthetic MNIST 60000 x 784 on the 8-bit grid (BENCH_DATASET=digits:
     scikit-learn's real 8x8 digits);
  2. exact Kronecker Gauss-Newton metric, Newton MAP, class Fisher at the MAP
     (ops.kron_metric.cached_gn_setup);
  3. HMC in whitened coordinates e = M^{1/2} (q - q_map), BENCH_CHAINS chains
     at fixed L, lazy-value trajectories: L-1 grad-only calls of the fused
     softmax-GLM kernel and one accurate value+grad call per draw;
  4. per-chain dual-averaging warmup (BENCH_WARMUP steps, target
     BENCH_TARGET_ACCEPT), no mass adaptation;
  5. an exact Gibbs move on the softmax gauge subspace after every draw;
  6. draws mapped back to parameter space and FFT ESS per coordinate.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"device", "detail"}; value = median ESS/s over all parameter coordinates
(sampling seconds only; setup and warmup are reported apart).  The default
device is cuda and the run fails without a card; ``--device cpu`` must be
asked for by name.  Unlike the JAX bench the sampling loop runs once: there
is no compile run to discard.
"""

from __future__ import annotations

import argparse
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
        dataset: str = "mnist", seed: int = 1) -> dict:
    """Run the whole headline pipeline on ``device``; returns the JSON record."""
    from . import full_f32_precision
    from .diagnostics.ess import effective_sample_size
    from .inference import hmc
    from .inference.warmup import run_warmup
    from .io import datasets
    from .models import Softmax
    from .ops.kron_metric import (cached_gn_setup, make_whitened_fused_vag,
                                  make_whitened_gauge_gibbs)
    from .ops.softmax_glm import launch_counts
    from .utils.profiling import SamplerStats

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
    metric, aux, qmap, _ = cached_gn_setup(X, y, model, alpha=ALPHA, newton_steps=60,
                                           cache_dir=None)
    map_acc = float((model.predict(qmap, X) == yi).float().mean())
    _sync(dev)
    t_setup = time.perf_counter() - t_setup0
    log(f"metric setup: {t_setup:.1f}s {aux['timings']}; MAP train acc {map_acc:.4f}")

    gauge_gibbs = make_whitened_gauge_gibbs(metric, aux, qmap)
    batched_vag, batched_grad = make_whitened_fused_vag(model, metric, qmap, (X, y))
    kernel = hmc.build_batched_kernel(batched_vag, num_integration_steps,
                                      grad_fn=batched_grad)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    # Laplace init is exactly e ~ N(0, I) in whitened coordinates
    e0 = {"weights": torch.randn((chains, d, NUM_CLASSES), generator=gen, device=dev),
          "bias": torch.randn((chains, NUM_CLASSES), generator=gen, device=dev)}
    t0 = time.perf_counter()
    state = hmc.batched_init(e0, batched_vag)
    warm = run_warmup(kernel, state, warmup,
                      initial_step_size=torch.full((chains,), 0.1, device=dev),
                      target_acceptance=target_accept, adapt_mass=False,
                      generator=gen)
    _sync(dev)
    t_warm = time.perf_counter() - t0
    ss = warm.step_size.cpu().numpy()
    log(f"warmup ({warmup} steps): {t_warm:.1f}s; step size median="
        f"{np.median(ss):.4f} min={ss.min():.4f} max={ss.max():.4f}")

    e_w = torch.empty((chains, draws, d, NUM_CLASSES), device=dev)
    e_b = torch.empty((chains, draws, NUM_CLASSES), device=dev)
    acc_sum = torch.zeros((chains,), device=dev)
    div_sum = torch.zeros((chains,), device=dev)
    stats = SamplerStats(num_chains=chains).start()
    st = hmc.batched_init(warm.state.position, batched_vag)
    for t in range(draws):
        st, info = kernel(st, warm.step_size, warm.inv_mass, generator=gen)
        st = gauge_gibbs(st, generator=gen)
        e_w[:, t] = st.position["weights"]
        e_b[:, t] = st.position["bias"]
        acc_sum += info.acceptance_prob
        div_sum += info.is_divergent
    _sync(dev)
    stats.stop(draws=chains * draws, grad_evals=chains * draws * num_integration_steps)
    t_sample = stats.seconds

    # back to parameter space, one chain at a time, in place
    t0 = time.perf_counter()
    for c in range(chains):
        dq = metric.unwhiten({"weights": e_w[c], "bias": e_b[c]})
        e_w[c] = qmap["weights"] + dq["weights"]
        e_b[c] = qmap["bias"] + dq["bias"]
    ess = torch.cat([effective_sample_size(e_w, block_size=512).reshape(-1),
                     effective_sample_size(e_b).reshape(-1)]).cpu().numpy()
    t_ess = time.perf_counter() - t0

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

    return {
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
            "path": "cuda-kernel" if dev.type == "cuda" else "torch-plain",
            "kernel_launches": dict(launch_counts),
            "sampler": "hmc",
            "num_integration_steps": num_integration_steps,
            "target_accept": target_accept,
            "warmup": "dual-averaging",
            "dataset": provenance,
        },
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when named)")
    args = parser.parse_args(argv)

    if os.environ.get("BENCH_SAMPLER", "hmc") != "hmc":
        raise NotImplementedError("BENCH_SAMPLER=nuts: batched NUTS is not ported yet")
    if os.environ.get("BENCH_CHEES", "0") == "1":
        raise NotImplementedError("BENCH_CHEES=1: ChEES warmup is not ported yet")
    if int(os.environ.get("BENCH_CHAIN_SHARDS", "1")) > 1:
        raise NotImplementedError("BENCH_CHAIN_SHARDS>1: chain sharding is not ported yet")
    result = run(
        device=args.device,
        chains=int(os.environ.get("BENCH_CHAINS", "128")),
        warmup=int(os.environ.get("BENCH_WARMUP", "300")),
        draws=int(os.environ.get("BENCH_DRAWS", "1000")),
        num_integration_steps=int(os.environ.get("BENCH_L", "10")),
        target_accept=float(os.environ.get("BENCH_TARGET_ACCEPT", "0.5")),
        dataset=os.environ.get("BENCH_DATASET", "mnist"),
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
