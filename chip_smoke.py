#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile csrc/softmax_glm.cu for sm_90a (seconds, ptxas report,
     and the count of HGMMA tensor-core instructions in the library's SASS);
  3. kernel against plain: both variants of the fused softmax-GLM kernel
     against the plain PyTorch version on the same inputs (f32, and float64
     for the value), and two calls against each other (bit-identical), at
     small ragged shapes (X on the 8-bit grid; X off it, which runs the X_lo
     passes; K = 7) and at the bench shape (N=60000, D=784, K=10, C=128, X
     on the 8-bit grid); per-call and per-stage times from CUDA events;
  4. main path: the port bench (synthetic MNIST 60000 x 784, full metric
     setup, 128 chains, L=10, target 0.5) cut to 50 warmup steps and 100
     draws; its JSON line, checks on its outputs, and the kernel launch
     counts of that run against the calls the path makes;
  5. NUTS path: the same bench with BENCH_SAMPLER=nuts at depth cap 4 (128
     chains), cut to 50 warmup steps and 50 draws; checks on its outputs, and
     value+grad launches = the 2 inits + the lockstep leaves the kernel ran;
  6. CLI: ``mnist-nuts`` on the synthetic MNIST, 128 chains, 50 warmup, 50
     draws, depth cap 4; its JSON line and checks (R-hat finite, train and
     predictive accuracy above 0.85);
  7. ChEES: the HMC bench with ChEES warmup, 50 warmup steps and 50 draws;
     checks (finite step, 1 <= L <= 64, finite ESS) and exact launch counts;
  8. configs 1-2 through the CLI: ``mvn-hmc`` (HMC, 4 chains x 1000 draws:
     mean within 0.1 and covariance within 0.15 of the target, min ESS >
     2000, max R-hat < 1.01, acceptance in (0.6, 0.99), zero divergences),
     and, cut to 300 draws with the bounds scaled to the draw count,
     ``mvn-hmc --nuts`` (4 x 300: min ESS >= half the draws, max R-hat <
     1.02, the moment bounds widened by sqrt(1000 / 300)) and
     ``logistic-hmc`` (32 x 300: test accuracy >= 0.98, max R-hat < 1.02,
     min ESS >= half the draws), and random-walk Metropolis on the same 2-D
     MVN through ``run_warmup_scale`` (moments within 0.15); draws/s and the
     device's busy share of each;
  9. the per-chain ``mnist-nuts`` modes on the synthetic MNIST (128 chains,
     depth cap 4, 30 warmup + 30 draws): ``--per-chain-nuts`` (finite R-hat,
     train and predictive accuracy > 0.85, zero divergences, <= 15 leaves)
     and ``--diag-mass`` (finite outputs, adapted inverse mass off the
     identity).  Both run the plain autograd value+grad: the fused kernel is
     launched no time;
 10. config 4 at full width through the CLI: ``mnist-mlp-sgmcmc`` (the
     784-256-256-10 dropout MLP, 268,810 parameters, synthetic MNIST 60000 x
     784, 16 chains, batch 1024, 3000 SGD steps, then 1000 burn-in + 2000
     steps, every 20th kept) with ``--algorithm sghmc`` (step 1e-5) and
     ``--algorithm sgld --step-size 1e-6``: finite outputs, dropout in the
     potential, train / predictive / MC-dropout accuracy >= 0.95, predictive
     NLL <= 0.30, log-density max R-hat < 1.2, SGHMC's predictive-trace
     median ESS above SGLD's; and at 60 steps the same seed twice gives
     bit-identical draws while ``--p-drop 0`` gives other ones;
 11. config 6: ``mnist-vi --model softmax`` (3000 steps) and ``--model mlp
     --init-log-std -6 --learning-rate 3e-3 --num-steps 4000``: predictive
     accuracy >= 0.95, NLL <= 0.32, last ELBO above first;
 12. config 5: ``plantvillage-smc --particles 256 --n-data 5000`` (HMC
     mutation) and ``--mutation sghmc --batch-size 1024 --step-size 1e-3
     --mcmc-steps 40``: lambda reaches 1 in 10..100 stages, predictive
     accuracy >= 0.99, finite log evidence; under HMC every stage's
     acceptance in (0.4, 1.0], the final step size above the first, and the
     log evidence within 10% of -738.2 (the JAX package's recorded run).
Phases 10-12 print seconds, steps/s and the device's busy share, and run no
fused kernel (the JAX package computes these paths outside any Pallas
kernel).  Every phase prints its seconds.
Phases 4-12 each count the kernel's launches from zero just before the run
and read them just after.  Then one JSON line describing each kernel (its
launches summed over phases 4-12, its bound from the bytes and operations of
the bench-shape call; ``library_ms`` is null because no single PyTorch call
computes the function: the plain version is two matmuls and a log_softmax),
and last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Without a CUDA device it exits non-zero before printing any result.
"""

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

WARMUP, DRAWS, CHAINS, L = 50, 100, 128, 10
SMALL_DRAWS = 300        # mvn-hmc --nuts and logistic-hmc, cut from 1000 draws
SGMCMC_CHAINS, SMC_PARTICLES = 16, 256
SMC_LOG_EVIDENCE = -738.2   # the JAX package's recorded config-5 run (RESULTS.md)
NUTS_WARMUP, NUTS_DRAWS, NUTS_DEPTH = 50, 50, 4
PER_CHAIN_WARMUP, PER_CHAIN_DRAWS = 30, 30
# NVIDIA's data sheet for the H100 SXM: dense bf16 tensor-core rate (the
# kernel's products are bf16 pieces), and the HBM3 rate
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
SOURCE = "dropout_hamiltonian_montecarlo_tpu_torch/csrc/softmax_glm.cu"
REPLACES = "dropout_hamiltonian_montecarlo_tpu/ops/pallas_glm.py:98"
# tolerances: the value feeds the MH accept, whose energy delta is O(1), so
# 0.1 nat per chain, against the f32 plain version and against a float64
# evaluation of the same formula (the f32 result's own ulp at |ll| ~ 1.5e5 is
# 0.0156 nat, so f32-plain alone cannot show the kernel's error); gradients
# within rtol 1e-3 and atol 3.9e-3 max|g| (the JAX kernel's fast-mode bound),
# and also within 1e-4 max|g| absolute, which a single-pass bf16 backward
# (~1.6e-3 max|g|) would miss: f32 accuracy
VALUE_ATOL = 0.1
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 3.9e-3
F32_ATOL_FRAC = 1e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def make_inputs(torch, n, d, k, c, seed, w_scale, grid=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if grid:   # the 8-bit grid k/256 of the bench data: exact in bf16
        X = torch.randint(0, 256, (n, d), generator=g, device="cuda").float() / 256.0
    else:
        X = torch.randn((n, d), generator=g, device="cuda")
    yi = torch.randint(0, k, (n,), generator=g, device="cuda")
    Y = torch.nn.functional.one_hot(yi, k).float()
    W = w_scale * torch.randn((c, d, k), generator=g, device="cuda")
    b = 0.1 * torch.randn((c, k), generator=g, device="cuda")
    return X, Y, W, b


def compare(torch, sg, X, Y, W, b, alpha, x_split):
    """Kernel (both variants) against plain; returns the max abs errors and,
    for the gradients, the max abs errors over max|g|."""
    ref_v, ref_gw, ref_gb = sg.softmax_value_and_grad_plain(X, Y, W, b)
    ref_v = ref_v + sg.log_prior_batched(W, b, alpha)
    ref_gw, ref_gb = ref_gw - alpha * W, ref_gb - alpha * b
    ll64, _, _ = sg.softmax_value_and_grad_plain(X.double(), Y.double(), W.double(),
                                                 b.double())
    v, gw, gb = sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=True, x_split=x_split)
    v2, gw2, gb2 = sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=False,
                                             x_split=x_split)
    again = (sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=True, x_split=x_split)
             + sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=False, x_split=x_split))
    torch.cuda.synchronize()
    if v2 is not None:
        fail("grad-only variant returned a value")
    for name, first, second in zip(("value", "gw", "gb", "-", "gw_gradonly", "gb_gradonly"),
                                   (v, gw, gb, v2, gw2, gb2), again):
        if first is not None and not torch.equal(first, second):
            fail(f"{name}: two calls on the same inputs differ")
    v64 = v.double() - sg.log_prior_batched(W, b, alpha).double()
    errs = {"value": float((v - ref_v).abs().max()),
            "value_vs_f64": float((v64 - ll64).abs().max())}
    for name, got, ref in (("gw", gw, ref_gw), ("gb", gb, ref_gb),
                           ("gw_gradonly", gw2, ref_gw), ("gb_gradonly", gb2, ref_gb)):
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} not finite")
        errs[name] = float((got - ref).abs().max())
        gmax = float(ref.abs().max())
        errs[name + "_over_max_g"] = errs[name] / gmax
        atol = GRAD_ATOL_FRAC * gmax
        bad = (got - ref).abs() > atol + GRAD_RTOL * ref.abs()
        if bool(bad.any()):
            fail(f"{name}: {int(bad.sum())} elements beyond rtol {GRAD_RTOL} "
                 f"atol {atol:.3g} (max abs err {errs[name]:.3g})")
        if errs[name] > F32_ATOL_FRAC * gmax:
            fail(f"{name}: max abs err {errs[name]:.3g} > {F32_ATOL_FRAC} max|g| "
                 f"({gmax:.4g}): not f32-accurate")
    for key in ("value", "value_vs_f64"):
        if errs[key] > VALUE_ATOL:
            fail(f"{key} error {errs[key]:.4g} > {VALUE_ATOL} nat")
    return errs


def check_finite(det: dict, keys) -> None:
    for key in keys:
        if not math.isfinite(det[key]):
            fail(f"{key} is not finite: {det[key]}")


def run_cli(torch, cli, module, argv, name="sample_posterior"):
    """One CLI run with its JSON line parsed; the arguments, the result and
    the wall seconds of its call to ``module.name`` (the library function
    under the subcommand) are captured on the way, for the checks the JSON
    line has no key for."""
    seen = {}
    inner = getattr(module, name)

    def capture(*args, **kwargs):
        t0 = time.perf_counter()
        result = inner(*args, **kwargs)
        torch.cuda.synchronize()
        seen.update(args=args, kwargs=kwargs, result=result,
                    seconds=time.perf_counter() - t0)
        if name == "sample_posterior":
            seen.update(kernel=args[1], post=result, generator=kwargs["generator"])
        return result

    setattr(module, name, capture)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    finally:
        setattr(module, name, inner)
    torch.cuda.synchronize()
    line = out.getvalue().strip().splitlines()[-1]
    return line, json.loads(line), seen


def rounded(x, digits=4):
    return None if x is None else round(x, digits)


def smc_round(torch, sgmcmc, mutation, state, info, log_prior, log_lik, kw):
    """One mutation round of a finished tempered-SMC run, at lambda = 1 on its
    final particles with its last step size: the step whose busy share is
    read (a stage is ``num_mcmc_steps`` of them, after one init)."""
    n = state.log_weights.shape[0]
    gen = kw["generator"]
    eps = info.stage_step_size[int(info.num_stages) - 1]
    if mutation == "hmc":
        def posterior(p):
            return log_prior(p) + log_lik(p)

        posterior.chain_batched = True
        kernel = kw["kernel_builder"](posterior)
        start = kw["init_builder"](posterior)(state.particles)
        inv_mass = {k: torch.ones_like(v) for k, v in state.particles.items()}
        return lambda: kernel(start, eps.expand(n), inv_mass, generator=gen)

    data, batch_size = kw["data"], kw["batch_size"]
    scale = data[0].shape[0] / batch_size

    def tempered(p, b):
        return log_prior(p) + scale * kw["log_likelihood_batch_fn"](p, b)

    tempered.chain_batched = True
    kernel = sgmcmc.build_sghmc_kernel(tempered)
    start = sgmcmc.sghmc_init(state.particles)

    def step():
        idx = torch.randint(0, data[0].shape[0], (batch_size,), generator=gen,
                            device=data[0].device)
        kernel(start, tuple(d[idx] for d in data), eps, generator=gen)

    return step


def busy_share(torch, step, n):
    """(ms per call of ``step``, device-busy share): the kernel time that
    torch.profiler sums over ``n`` calls, over the wall time of ``n``
    unprofiled calls.  The share is None if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # kernels and copies only: an operator's row repeats its kernels' time
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    return wall / n * 1e3, (device_us / 1e6 / wall if device_us else None)


def draw_rate(torch, seen, steps, n=10):
    """Draws/s of a captured run (all chains, warmup steps included) and the
    busy share of ``n`` more steps of its kernel from its final state."""
    post = seen["post"]
    chains = post.step_size.shape[0]

    def step():
        seen["kernel"](post.final_state, post.step_size, post.inv_mass,
                       generator=seen["generator"])

    ms, busy = busy_share(torch, step, n)
    return {"chain_draws_per_s": round(chains * steps / seen["seconds"], 1),
            "ms_per_step": round(ms, 3), "busy_share": None if busy is None else round(busy, 4)}


def check_moments(name, x, mean, cov, mean_atol, cov_atol) -> None:
    import numpy as np

    flat = x.reshape(-1, x.shape[-1]).double().cpu().numpy()
    mean_err = float(np.abs(flat.mean(0) - mean).max())
    cov_err = float(np.abs(np.cov(flat.T) - cov).max())
    if mean_err > mean_atol or cov_err > cov_atol:
        fail(f"{name}: mean off by {mean_err:.3f} (> {mean_atol}) or covariance by "
             f"{cov_err:.3f} (> {cov_atol})")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from dropout_hamiltonian_montecarlo_tpu_torch import bench, cli, full_f32_precision
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import (metropolis, sampling, sgmcmc,
                                                                    smc, vi)
    from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets
    from dropout_hamiltonian_montecarlo_tpu_torch.models import MVNGaussian
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg
    from dropout_hamiltonian_montecarlo_tpu_torch.ops.cuda_build import BUILD_INFO, find_nvcc
    from dropout_hamiltonian_montecarlo_tpu_torch.utils.profiling import cuda_time_ms

    full_f32_precision()
    clock = {"t": time.perf_counter()}

    def phase_seconds(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"{name} took {now - clock['t']:.1f}s", flush=True)
        clock["t"] = now

    # the synthetic MNIST is a pure function of nothing: generate it once for
    # all the phases that load it
    mnist_arrays = datasets.mnist()
    datasets.mnist = lambda: mnist_arrays

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"phase 1 device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    print(smi.splitlines()[0], flush=True)

    # ---- 2. build -------------------------------------------------------
    build_s = sg.build_kernel()
    info = BUILD_INFO["softmax_glm"]
    ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
             if "registers" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln)]
    sass = subprocess.run([str(Path(find_nvcc()).with_name("cuobjdump")), "-sass", info["path"]],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    hgmma = sass.count("HGMMA")
    print(f"phase 2 build: {build_s:.1f}s; HGMMA instructions in SASS: {hgmma}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)
    if hgmma == 0:
        fail("the kernel library holds no HGMMA (wgmma) instruction")
    phase_seconds("phases 1-2")

    # ---- 3. kernel against plain ---------------------------------------
    alpha = 1.0
    small = {}
    for label, shape, grid in (("N=1000,D=64,K=10,C=3", (1000, 64, 10, 3), True),
                               ("N=257,D=33,K=10,C=17,off-grid", (257, 33, 10, 17), False),
                               ("N=300,D=50,K=7,C=20", (300, 50, 7, 20), True)):
        X, Y, W, b = make_inputs(torch, *shape, 0, 0.3, grid)
        split = sg.split_bf16_input(X)
        if (split[1] is None) != grid:
            fail(f"{label}: X_lo piece {'absent' if grid else 'present'} on the wrong grid")
        small[label] = compare(torch, sg, X, Y, W, b, alpha, split)
    Xb, Yb, Wb, bb = make_inputs(torch, 60000, 784, 10, CHAINS, 1, 0.05)
    split = sg.split_bf16_input(Xb)
    big = compare(torch, sg, Xb, Yb, Wb, bb, alpha, split)
    print("phase 3 kernel vs plain, errors: small " + json.dumps(small)
          + "; bench(N=60000,D=784,K=10,C=128) " + json.dumps(big), flush=True)
    stages = {}
    for name, full in (("value+grad", True), ("grad-only", False)):
        call = sg.KernelCall(split, Yb, Wb, bb, with_value=full)
        stages[name] = {st: cuda_time_ms(getattr(call, st), 10, 2)
                        for st in ("forward", "backward", "finish")}
    print("phase 3 ms per stage: " + json.dumps(stages), flush=True)
    ms_full = cuda_time_ms(
        lambda: sg.softmax_value_and_grad(Xb, Yb, Wb, bb, alpha, x_split=split), 10, 3)
    ms_grad = cuda_time_ms(lambda: sg.softmax_value_and_grad(
        Xb, Yb, Wb, bb, alpha, fwd_full=False, x_split=split), 10, 3)
    ms_plain = cuda_time_ms(lambda: sg.softmax_value_and_grad_plain(Xb, Yb, Wb, bb), 10, 3)
    flop = 2 * 2 * 60000 * 784 * 10 * CHAINS
    print(f"phase 3 ms/call value+grad {ms_full:.3f} grad-only {ms_grad:.3f} plain "
          f"{ms_plain:.3f}; TFLOP/s (two f32-equivalent GEMMs) value+grad "
          f"{flop / ms_full / 1e9:.2f} grad-only {flop / ms_grad / 1e9:.2f} plain "
          f"{flop / ms_plain / 1e9:.2f}", flush=True)
    # the least time the card could take for one call: each input read once
    # (X in the bf16 the call is handed, 2 bytes an element; Y, W, b in f32),
    # each output written once (gW, gb, the values), against the two GEMMs
    # 2 N (D+1) K C at the dense bf16 tensor rate
    moved = 2 * Xb.numel() + 4 * (Yb.numel() + 2 * Wb.numel() + 2 * bb.numel() + CHAINS)
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    flop_ms = 2 * 2 * 60000 * 785 * 10 * CHAINS / PEAK_BF16_FLOPS * 1e3
    bound_ms, bound_by = max(bytes_ms, flop_ms), "operations" if flop_ms >= bytes_ms else "bytes"
    print(f"phase 3 bound: {bound_ms:.4f} ms by {bound_by} ({flop_ms:.4f} ms for 2 GEMMs of "
          f"2*60000*785*1280 flop at 989 TFLOP/s bf16; {bytes_ms:.4f} ms for {moved / 1e6:.1f} "
          f"MB at 3.35 TB/s); the exact bf16 splits run 5 passes for value+grad "
          f"({2.5 * flop_ms:.4f} ms) and 4 grad-only ({2 * flop_ms:.4f} ms)", flush=True)
    del Xb, Yb, Wb, bb, split, call
    torch.cuda.empty_cache()
    phase_seconds("phase 3")

    # ---- 4. main path ---------------------------------------------------
    sg.reset_launch_counts()
    result = bench.run(device="cuda", chains=CHAINS, warmup=WARMUP, draws=DRAWS,
                       num_integration_steps=L, target_accept=0.5, dataset="mnist")
    torch.cuda.synchronize()
    counts = dict(sg.launch_counts)
    print("phase 4 main path: " + json.dumps(result), flush=True)
    det = result["detail"]
    check_finite(det, ("ess_median", "ess_min", "acceptance", "sample_seconds"))
    if not math.isfinite(result["value"]):
        fail(f"ESS/s is not finite: {result['value']}")
    if not 0.2 < det["acceptance"] < 0.95:
        fail(f"acceptance {det['acceptance']} outside (0.2, 0.95)")
    if det["map_train_accuracy"] < 0.85:
        fail(f"MAP train accuracy {det['map_train_accuracy']} < 0.85")
    if det["divergent_frac"] > 0.01:
        fail(f"divergent fraction {det['divergent_frac']}")
    want = {"grad": (WARMUP + DRAWS) * (L - 1), "value_and_grad": WARMUP + DRAWS + 2}
    if counts != want:
        fail(f"kernel launches {counts} != the path's calls {want}")
    print(f"phase 4 launch counts: {counts} (expected {want})", flush=True)
    total = dict(counts)

    def add(c):
        for key in total:
            total[key] += c[key]

    phase_seconds("phase 4")

    # ---- 5. NUTS bench path -----------------------------------------------
    sg.reset_launch_counts()
    result = bench.run(device="cuda", chains=CHAINS, warmup=NUTS_WARMUP, draws=NUTS_DRAWS,
                       target_accept=0.5, dataset="mnist", sampler="nuts",
                       nuts_depth=NUTS_DEPTH)
    torch.cuda.synchronize()
    counts = dict(sg.launch_counts)
    add(counts)
    print("phase 5 NUTS path: " + json.dumps(result), flush=True)
    det = result["detail"]
    check_finite(det, ("ess_median", "ess_min", "acceptance", "num_integration_steps"))
    if not math.isfinite(result["value"]):
        fail(f"NUTS ESS/s is not finite: {result['value']}")
    if not 0.2 < det["acceptance"] < 0.99:
        fail(f"NUTS acceptance {det['acceptance']} outside (0.2, 0.99)")
    if det["divergent_frac"] > 0.01:
        fail(f"NUTS divergent fraction {det['divergent_frac']}")
    if det["num_integration_steps"] > 2 ** NUTS_DEPTH - 1:
        fail(f"NUTS mean leaves per draw {det['num_integration_steps']} > "
             f"{2 ** NUTS_DEPTH - 1}")
    want = {"grad": 0, "value_and_grad": 2 + det["lockstep_leaves"]}
    if counts != want:
        fail(f"NUTS kernel launches {counts} != 2 inits + the lockstep leaves {want}")
    print(f"phase 5 launch counts: {counts} (expected {want})", flush=True)
    phase_seconds("phase 5")

    # ---- 6. CLI -------------------------------------------------------------
    sg.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["mnist-nuts", "--chains", str(CHAINS), "--samples", str(NUTS_DRAWS),
                  "--warmup", str(NUTS_WARMUP), "--max-depth", str(NUTS_DEPTH)])
    torch.cuda.synchronize()
    counts = dict(sg.launch_counts)
    add(counts)
    line = out.getvalue().strip().splitlines()[-1]
    print("phase 6 CLI: " + line, flush=True)
    agg = json.loads(line)
    check_finite(agg, ("max_rhat", "min_ess", "median_ess"))
    for key in ("train_accuracy", "predictive_accuracy"):
        if not agg[key] > 0.85:
            fail(f"CLI {key} {agg[key]} <= 0.85")
    if counts["grad"] != 0 or counts["value_and_grad"] < NUTS_WARMUP + NUTS_DRAWS:
        fail(f"CLI kernel launches {counts}")
    print(f"phase 6 launch counts: {counts}", flush=True)
    phase_seconds("phase 6")

    # ---- 7. ChEES -----------------------------------------------------------
    sg.reset_launch_counts()
    result = bench.run(device="cuda", chains=CHAINS, warmup=NUTS_WARMUP, draws=NUTS_DRAWS,
                       target_accept=0.5, dataset="mnist", chees=True)
    torch.cuda.synchronize()
    counts = dict(sg.launch_counts)
    add(counts)
    print("phase 7 ChEES: " + json.dumps(result), flush=True)
    det = result["detail"]
    check_finite(det, ("ess_median", "ess_min", "step_size_median"))
    steps = int(det["num_integration_steps"])
    if not 1 <= steps <= 64 or det["warmup"] != "chees":
        fail(f"ChEES L = {steps} outside [1, 64] (warmup {det['warmup']})")
    want = {"grad": NUTS_DRAWS * (steps - 1),
            "value_and_grad": 2 + det["chees_leapfrog_steps"] + NUTS_DRAWS}
    if counts != want:
        fail(f"ChEES kernel launches {counts} != the path's calls {want}")
    print(f"phase 7 launch counts: {counts} (expected {want})", flush=True)
    phase_seconds("phase 7")

    # ---- 8. configs 1-2 through the CLI, Metropolis --------------------------
    sg.reset_launch_counts()
    target_cov = torch.tensor([[1.5, 0.5], [0.5, 1.5]])
    widen = math.sqrt(1000 / SMALL_DRAWS)     # a moment's error goes as 1/sqrt(draws)
    for extra, draws, ess_floor, rhat_cap, mean_atol, cov_atol in (
            ([], 1000, 2000, 1.01, 0.1, 0.15),
            (["--nuts"], SMALL_DRAWS, 0.5 * 4 * SMALL_DRAWS, 1.02, 0.1 * widen, 0.15 * widen)):
        line, agg, seen = run_cli(torch, cli, sampling,
                                  ["mvn-hmc", "--chains", "4", "--samples", str(draws)] + extra)
        post = seen["post"]
        rate = draw_rate(torch, seen, 300 + draws)
        acc = float(post.infos.acceptance_prob.mean())
        label = "mvn-hmc " + " ".join(extra)
        print(f"phase 8 {label}: {line}; acceptance {acc:.4f}, leapfrog steps per draw "
              f"{float(post.infos.num_integration_steps.float().mean()):.2f}; "
              + json.dumps(rate), flush=True)
        check_moments(label, post.positions["x"], 0.0, target_cov.numpy(), mean_atol, cov_atol)
        if not agg["min_ess"] > ess_floor or not agg["max_rhat"] < rhat_cap:
            fail(f"{label}: min ESS {agg['min_ess']} <= {ess_floor} or max R-hat "
                 f"{agg['max_rhat']} >= {rhat_cap}")
        if not 0.6 < acc < 0.99 or bool(post.infos.is_divergent.any()):
            fail(f"{label}: acceptance {acc} outside (0.6, 0.99) or a divergence")
        phase_seconds(f"phase 8 {label}")
    line, agg, seen = run_cli(torch, cli, sampling,
                              ["logistic-hmc", "--chains", "32", "--samples", str(SMALL_DRAWS)])
    print("phase 8 logistic-hmc: " + line + "; "
          + json.dumps(draw_rate(torch, seen, 300 + SMALL_DRAWS)), flush=True)
    if (agg["test_accuracy"] < 0.98 or not agg["max_rhat"] < 1.02
            or agg["min_ess"] < 0.5 * 32 * SMALL_DRAWS):
        fail(f"logistic-hmc: accuracy {agg['test_accuracy']}, max R-hat {agg['max_rhat']}, "
             f"min ESS {agg['min_ess']}")
    phase_seconds("phase 8 logistic-hmc")

    gen = torch.Generator(device="cuda").manual_seed(0)
    logdensity = MVNGaussian(torch.zeros(2, device="cuda"), target_cov.cuda()).make_logdensity()
    mh = metropolis.build_kernel(logdensity)
    state = metropolis.init({"x": torch.randn((32, 2), generator=gen, device="cuda")},
                            logdensity)
    t0 = time.perf_counter()
    state, scale = metropolis.run_warmup_scale(mh, state, 1000, initial_scale=10.0,
                                               generator=gen)
    xs, accepted = [], []
    for _ in range(3000):
        state, info = mh(state, scale, generator=gen)
        xs.append(state.position["x"])
        accepted.append(info.is_accepted)
    torch.cuda.synchronize()
    mh_s = time.perf_counter() - t0
    ms, busy = busy_share(torch, lambda: mh(state, scale, generator=gen), 50)
    print(f"phase 8 metropolis: 32 chains, 1000 tuning + 3000 draws in {mh_s:.2f}s "
          f"({32 * 4000 / mh_s:.1f} chain-steps/s, {ms:.3f} ms per step, busy share "
          f"{busy if busy is None else round(busy, 4)}); acceptance "
          f"{float(torch.stack(accepted).float().mean()):.3f}; scale "
          f"{float(scale.min()):.3f}-{float(scale.max()):.3f}", flush=True)
    check_moments("metropolis", torch.stack(xs), 0.0, target_cov.numpy(), 0.15, 0.15)
    counts = dict(sg.launch_counts)
    add(counts)
    if any(counts.values()):
        fail(f"phase 8 launched the fused kernel: {counts}")
    phase_seconds("phase 8 metropolis")

    # ---- 9. the per-chain mnist-nuts modes -----------------------------------
    sg.reset_launch_counts()
    common = ["mnist-nuts", "--chains", str(CHAINS), "--samples", str(PER_CHAIN_DRAWS),
              "--warmup", str(PER_CHAIN_WARMUP), "--max-depth", str(NUTS_DEPTH)]
    line, agg, seen = run_cli(torch, cli, sampling, common + ["--per-chain-nuts"])
    post = seen["post"]
    leaves = float(post.infos.num_integration_steps.double().mean())
    print(f"phase 9 --per-chain-nuts: {line}; leaves per draw {leaves:.2f}, acceptance "
          f"{float(post.infos.acceptance_prob.mean()):.4f}; "
          + json.dumps(draw_rate(torch, seen, PER_CHAIN_WARMUP + PER_CHAIN_DRAWS, n=5)),
          flush=True)
    check_finite(agg, ("max_rhat", "min_ess", "median_ess"))
    for key in ("train_accuracy", "predictive_accuracy"):
        if not agg[key] > 0.85:
            fail(f"--per-chain-nuts {key} {agg[key]} <= 0.85")
    if bool(post.infos.is_divergent.any()) or leaves > 2 ** NUTS_DEPTH - 1:
        fail(f"--per-chain-nuts: a divergence, or {leaves} leaves per draw")
    line, agg, seen = run_cli(torch, cli, sampling, common + ["--diag-mass"])
    inv_mass = seen["post"].inv_mass
    print(f"phase 9 --diag-mass: {line}; inverse mass "
          f"{float(inv_mass['weights'].min()):.3g}-{float(inv_mass['weights'].max()):.3g}; "
          + json.dumps(draw_rate(torch, seen, PER_CHAIN_WARMUP + PER_CHAIN_DRAWS, n=5)),
          flush=True)
    check_finite(agg, ("max_rhat", "min_ess", "median_ess", "train_accuracy",
                       "predictive_accuracy", "predictive_nll"))
    if not all(bool(torch.isfinite(v).all()) for v in inv_mass.values()):
        fail("--diag-mass: the adapted inverse mass is not finite")
    if all(bool((v == 1).all()) for v in inv_mass.values()):
        fail("--diag-mass: the inverse mass is still the identity")
    counts = dict(sg.launch_counts)
    add(counts)
    if any(counts.values()):
        fail(f"phase 9 launched the fused kernel: {counts}")
    print(f"phases 8-9 launch counts of the fused kernel: {counts} (expected zeros)",
          flush=True)
    phase_seconds("phase 9")

    # ---- 10. config 4: the dropout MLP under SGHMC and SGLD ------------------
    sg.reset_launch_counts()
    sgmcmc_common = ["mnist-mlp-sgmcmc", "--chains", str(SGMCMC_CHAINS)]
    traces = {}
    for algorithm, extra in (("sghmc", []), ("sgld", ["--step-size", "1e-6"])):
        line, agg, seen = run_cli(
            torch, cli, sgmcmc, sgmcmc_common + ["--algorithm", algorithm, "--collect-every",
                                                 "20"] + extra, name="run_sgmcmc_chains")
        kernel, _, chains, data = seen["args"][:4]
        kw, final_state = seen["kwargs"], seen["result"][0]
        step_size = kw["step_size_schedule"](torch.zeros((), device="cuda"))

        def step():
            idx = torch.randint(0, data[0].shape[0], (chains, kw["batch_size"]),
                                generator=kw["generator"], device="cuda")
            kernel(final_state, tuple(d[idx] for d in data), step_size,
                   generator=kw["generator"])

        ms, busy = busy_share(torch, step, 20)
        print(f"phase 10 mnist-mlp-{algorithm}: {line}; " + json.dumps({
            "seconds": round(seen["seconds"], 2),
            "chain_steps_per_s": round(chains * kw["num_steps"] / seen["seconds"], 1),
            "ms_per_step": round(ms, 3), "busy_share": rounded(busy)}), flush=True)
        check_finite(agg, ("predictive_ece", "predictive_nll", "min_ess", "median_ess",
                           "max_rhat", "logdensity_ess", "logdensity_rhat",
                           "predictive_trace_min_ess", "predictive_trace_median_ess",
                           "predictive_trace_max_rhat", "steps_per_sec"))
        positions = seen["result"][1]
        if not all(bool(torch.isfinite(v).all()) for v in positions.values()):
            fail(f"mnist-mlp-{algorithm}: a draw is not finite")
        if positions["W1"].shape != (SGMCMC_CHAINS, 100, 784, 256) or agg["dropout"] is not True:
            fail(f"mnist-mlp-{algorithm}: draws {tuple(positions['W1'].shape)}, dropout "
                 f"{agg['dropout']}")
        for key in ("train_accuracy", "predictive_accuracy", "mc_dropout_accuracy"):
            if not agg[key] >= 0.95:
                fail(f"mnist-mlp-{algorithm}: {key} {agg[key]} < 0.95")
        if not agg["predictive_nll"] <= 0.30 or not agg["logdensity_rhat"] < 1.2:
            fail(f"mnist-mlp-{algorithm}: predictive NLL {agg['predictive_nll']} > 0.30 or "
                 f"log-density max R-hat {agg['logdensity_rhat']} >= 1.2")
        traces[algorithm] = agg["predictive_trace_median_ess"]
        del positions, seen, final_state, data
        torch.cuda.empty_cache()
        phase_seconds(f"phase 10 mnist-mlp-{algorithm}")
    if not traces["sghmc"] > traces["sgld"]:
        fail(f"predictive-trace median ESS: SGHMC {traces['sghmc']} <= SGLD {traces['sgld']}")

    # the keyed-mask property: the masks are a function of the seeded stream
    short = sgmcmc_common + ["--num-steps", "60", "--burnin-steps", "20", "--collect-every",
                             "10", "--sgd-init-steps", "50"]
    runs = [run_cli(torch, cli, sgmcmc, short + extra, name="run_sgmcmc_chains")[2]["result"][1]
            for extra in ([], [], ["--p-drop", "0"])]
    if not all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]):
        fail("mnist-mlp-sgmcmc: the same seed twice gives different draws")
    gap = max(float((runs[0][k] - runs[2][k]).abs().max()) for k in runs[0])
    if not gap > 1e-6:
        fail("mnist-mlp-sgmcmc: --p-drop 0 gives the draws of --p-drop 0.1")
    print(f"phase 10 determinism: 16 chains x 4 draws bit-identical on a repeat; max |draw "
          f"difference| to --p-drop 0: {gap:.3g}", flush=True)
    del runs
    torch.cuda.empty_cache()
    counts = dict(sg.launch_counts)
    add(counts)
    if any(counts.values()):
        fail(f"phase 10 launched the fused kernel: {counts}")
    phase_seconds("phase 10 determinism")

    # ---- 11. config 6: mean-field ADVI ---------------------------------------
    sg.reset_launch_counts()
    for model, extra in (("softmax", []),
                         ("mlp", ["--init-log-std", "-6", "--learning-rate", "3e-3",
                                  "--num-steps", "4000"])):
        line, agg, seen = run_cli(torch, cli, vi, ["mnist-vi", "--model", model] + extra,
                                  name="fit")
        kernel, _, data, batch_size, num_steps = seen["args"]
        final_state, gen = seen["result"][0], seen["kwargs"]["generator"]

        def step():
            idx = torch.randint(0, data[0].shape[0], (batch_size,), generator=gen, device="cuda")
            kernel(final_state, tuple(d[idx] for d in data), generator=gen)

        ms, busy = busy_share(torch, step, 20)
        print(f"phase 11 mnist-vi-{model}: {line}; " + json.dumps({
            "seconds": round(seen["seconds"], 2),
            "steps_per_s": round(num_steps / seen["seconds"], 1), "ms_per_step": round(ms, 3),
            "busy_share": rounded(busy)}), flush=True)
        check_finite(agg, ("train_accuracy", "predictive_ece", "predictive_nll"))
        first, last = agg["elbo_first_last"]
        if (not agg["predictive_accuracy"] >= 0.95 or not agg["predictive_nll"] <= 0.32
                or not last > first):
            fail(f"mnist-vi-{model}: predictive accuracy {agg['predictive_accuracy']} < 0.95, "
                 f"NLL {agg['predictive_nll']} > 0.32, or ELBO {first} -> {last} did not rise")
        phase_seconds(f"phase 11 mnist-vi-{model}")
    counts = dict(sg.launch_counts)
    add(counts)
    if any(counts.values()):
        fail(f"phase 11 launched the fused kernel: {counts}")

    # ---- 12. config 5: adaptive tempered SMC ---------------------------------
    sg.reset_launch_counts()
    smc_common = ["plantvillage-smc", "--particles", str(SMC_PARTICLES), "--n-data", "5000"]
    for mutation, extra in (("hmc", []),
                            ("sghmc", ["--mutation", "sghmc", "--batch-size", "1024",
                                       "--step-size", "1e-3", "--mcmc-steps", "40"])):
        line, agg, seen = run_cli(torch, cli, smc, smc_common + extra, name="run_tempered_smc")
        state, info = seen["result"]
        _, log_prior, log_lik = seen["args"]
        kw = seen["kwargs"]
        ms, busy = busy_share(torch, smc_round(torch, sgmcmc, mutation, state, info, log_prior,
                                               log_lik, kw), 10)
        rounds = agg["num_stages"] * int(kw["num_mcmc_steps"])
        print(f"phase 12 plantvillage-smc {mutation}: {line}; " + json.dumps({
            "seconds": round(seen["seconds"], 2),
            "mutation_rounds_per_s": round(rounds / seen["seconds"], 1),
            "particle_rounds_per_s": round(SMC_PARTICLES * rounds / seen["seconds"], 1),
            "ms_per_round_at_lambda_1": round(ms, 3), "busy_share": rounded(busy),
            "log_evidence_over_recorded": round(agg["log_evidence"] / SMC_LOG_EVIDENCE, 4)}),
            flush=True)
        check_finite(agg, ("log_evidence", "predictive_ece", "train_accuracy"))
        if float(state.lmbda) != 1.0 or not 10 <= agg["num_stages"] <= 100:
            fail(f"plantvillage-smc {mutation}: lambda {float(state.lmbda)} after "
                 f"{agg['num_stages']} stages")
        if not agg["predictive_accuracy"] >= 0.99:
            fail(f"plantvillage-smc {mutation}: predictive accuracy "
                 f"{agg['predictive_accuracy']} < 0.99")
        if not all(bool(torch.isfinite(v).all()) for v in state.particles.values()):
            fail(f"plantvillage-smc {mutation}: a particle is not finite")
        if mutation == "hmc":
            first, last = agg["step_size_first_last"]
            if not 0.4 < agg["stage_acceptance_min"] <= agg["stage_acceptance_max"] <= 1.0:
                fail(f"plantvillage-smc: stage acceptance {agg['stage_acceptance_min']} .. "
                     f"{agg['stage_acceptance_max']} outside (0.4, 1.0]")
            if not last > first:
                fail(f"plantvillage-smc: step size {first} -> {last} did not grow")
            if abs(agg["log_evidence"] / SMC_LOG_EVIDENCE - 1.0) > 0.10:
                fail(f"plantvillage-smc: log evidence {agg['log_evidence']} is not within 10% "
                     f"of {SMC_LOG_EVIDENCE}")
        phase_seconds(f"phase 12 plantvillage-smc {mutation}")
    counts = dict(sg.launch_counts)
    add(counts)
    if any(counts.values()):
        fail(f"phase 12 launched the fused kernel: {counts}")
    print(f"phases 10-12 launch counts of the fused kernel: {counts} (expected zeros)",
          flush=True)

    kernels = [
        {"name": "softmax_glm_value_and_grad", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": total["value_and_grad"],
         "max_abs_err": max(big["value"], big["gw"], big["gb"]),
         "ms": ms_full, "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None},
        {"name": "softmax_glm_grad", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": total["grad"],
         "max_abs_err": max(big["gw_gradonly"], big["gb_gradonly"]),
         "ms": ms_grad, "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
