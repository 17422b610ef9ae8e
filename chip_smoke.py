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
     passes; K = 7), at the bench shape (N=60000, D=784, K=10, C=128, X on
     the 8-bit grid) and at the sharded phases' shapes (C=64; N=30000 with
     include_prior=False); per-call and per-stage times from CUDA events,
     and the forward's work items, persistent blocks and
     forward_items_overlapped;
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
  8. configs 1-2 through the CLI, cut to 300 draws with the bounds scaled
     to the draw count: ``mvn-hmc`` and ``mvn-hmc --nuts`` (4 chains x 300
     draws: mean within 0.1 and covariance within 0.15 of the target, both
     widened by sqrt(1000 / 300), min ESS >= half the draws, max R-hat <
     1.02, acceptance in (0.6, 0.99), zero divergences) and
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
 13. resume on the card at full width: config 3's pieces (128 chains, the
     synthetic MNIST 60000 x 784, lockstep NUTS at depth cap 4, 20 warmup
     steps) through ``sample_batched_streaming`` into the bounded draw buffer,
     100 draws in 4 chunks.  Run A is uninterrupted; run B stops after 2
     chunks and resumes from its checkpoint with warmup skipped and
     placeholder step sizes; B's draws must equal A's BIT FOR BIT, the
     checkpoint's counter must be right, and the value+grad launches of B's
     second half must equal the lockstep leaves it ran.  Then a crash between
     an append and its checkpoint write (one chunk more in the buffer than
     the checkpoint knows): the resume truncates and still equals A.  Prints
     seconds per chunk with and without the checkpoint write;
 14. the draw buffer: the same run with the threshold so low that the draws
     go to pinned host memory; min / median ESS and max R-hat from the
     blockwise diagnostics equal the device path's to rtol 1e-5; prints
     ``torch.cuda.max_memory_allocated`` of both, beside the card's name and
     power limit;
 15. files, only where ``h5py`` imports (one line says whether it does):
     ``mnist-nuts --save --stream-chunk 25 --checkpoint`` through the CLI,
     stopped by ``--samples``, resumed, the file read back and held against
     an uninterrupted run's (equal bit for bit); and ``--data PATH`` on a
     small file of off-grid pixels (k/255) that the script writes from a
     seed, whose launches must take the kernel's X_lo passes.
 16-18 run their ranks as processes, started by torchrun in two launches
     (``chip_smoke.py --rank-worker STEPS.json``), each running its steps in
     one process group: 2 ranks under gloo (NCCL takes one card a rank, and
     the two ranks share the one card), then 1 rank under NCCL; each step
     counts the kernel's launches from zero, and a failed or timed-out rank
     fails the run with the ranks' log.  Then each phase checks its steps:
 16. chain shards: the HMC headline of phase 4 through ``BENCH_CHAIN_SHARDS=2``
     (2 ranks x 64 chains, 50 warmup + 100 draws, rank 0's sampling loop
     under the profiler, the program's spans on) must equal the same two blocks
     run in this process through the sharded code BIT FOR BIT (a sha256 a
     chain), with 9 grad-only + 1 value+grad launches a draw on each rank;
     against phase 4's unblocked draws (the kernel's backward slices depend
     on C K, so 64-chain blocks round otherwise; phase 3 holds both shapes
     against plain) the acceptance within 0.05, the accept decisions that
     differ at most 2 p (1 - p) + 0.05, the largest draw difference within
     10 coordinate sd and every coordinate's mean within 6 sqrt(2 / min ESS)
     sd; the same run at world size 1 under NCCL must equal phase 4 bit for
     bit; and ``mnist-nuts --chain-shards 2`` (128 chains, cap 4, 50 + 50)
     must give every chain the tree sizes of the blockwise one-process run,
     exactly;
 17. data parallelism: the full-batch softmax value+grad at the bench shape
     over 2 ranks of 30,000 rows (the kernel with include_prior=False, one
     all-reduce, the prior once) within phase 3's tolerances of the
     one-process kernel call; ``mnist-mlp-sgmcmc --data-shards 2`` at full
     width (16 chains, global batch 1024, 1000 SGD steps, 300 steps): finite
     outputs, dropout in the potential, the seconds of gloo's all-reduce per
     step; and one data shard through ``run_sgmcmc_data_parallel`` equal to
     ``run_sgmcmc_chains`` bit for bit at full width;
 18. particle sharding: ``plantvillage-smc --particles 256 --n-data 5000
     --shard-particles`` against phase 12's run of the same seed: on one rank
     under NCCL the same line, bit for bit (stages, log evidence, accuracy);
     on 2 ranks (gloo; 128-particle blocks round their GEMMs otherwise) the
     same stage count, the log evidence within 0.1%, accuracy >= 0.99.
Phases 10-12 print seconds, steps/s and the device's busy share, and run no
fused kernel (the JAX package computes these paths outside any Pallas
kernel).  Every phase prints its seconds; phases 16-18 also the launch
counts of every rank and the card's name and power limit.
Phases 4-18 each count the kernel's launches from zero just before the run
and read them just after (a rank counts its own).  Then one JSON line
describing each kernel (its launches summed over phases 4-18 and all ranks,
its bound from the bytes and operations of
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
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WARMUP, DRAWS, CHAINS, L = 50, 100, 128, 10
SMALL_DRAWS = 300        # mvn-hmc, mvn-hmc --nuts and logistic-hmc, cut from 1000 draws
SGMCMC_CHAINS, SMC_PARTICLES = 16, 256
SMC_LOG_EVIDENCE = -738.2   # the JAX package's recorded config-5 run (RESULTS.md)
NUTS_WARMUP, NUTS_DRAWS, NUTS_DEPTH = 50, 50, 4
RESUME_WARMUP, RESUME_CHUNK, RESUME_CHUNKS = 20, 25, 4
PER_CHAIN_WARMUP, PER_CHAIN_DRAWS = 30, 30
# phase 17's config 4 on 2 data shards: SGD warm start, then steps (a third
# of them burn-in), cut from 3000 + 3000
DP_SGD_STEPS, DP_STEPS = 1000, 300
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


def compare(torch, sg, X, Y, W, b, alpha, x_split, include_prior=True):
    """Kernel (both variants) against plain; returns the max abs errors and,
    for the gradients, the max abs errors over max|g|.  ``include_prior=False``:
    the likelihood-only variant a data shard runs, against plain without the
    prior."""
    ref_v, ref_gw, ref_gb = sg.softmax_value_and_grad_plain(X, Y, W, b)
    if include_prior:
        ref_v = ref_v + sg.log_prior_batched(W, b, alpha)
        ref_gw, ref_gb = ref_gw - alpha * W, ref_gb - alpha * b
    ll64, _, _ = sg.softmax_value_and_grad_plain(X.double(), Y.double(), W.double(),
                                                 b.double())
    kw = dict(x_split=x_split, include_prior=include_prior)
    v, gw, gb = sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=True, **kw)
    v2, gw2, gb2 = sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=False, **kw)
    again = (sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=True, **kw)
             + sg.softmax_value_and_grad(X, Y, W, b, alpha, fwd_full=False, **kw))
    torch.cuda.synchronize()
    if v2 is not None:
        fail("grad-only variant returned a value")
    for name, first, second in zip(("value", "gw", "gb", "-", "gw_gradonly", "gb_gradonly"),
                                   (v, gw, gb, v2, gw2, gb2), again):
        if first is not None and not torch.equal(first, second):
            fail(f"{name}: two calls on the same inputs differ")
    v64 = v.double() - (sg.log_prior_batched(W, b, alpha).double() if include_prior else 0.0)
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


def device_seconds(prof) -> float:
    """The device's kernel and copy seconds in a finished ``torch.profiler``
    session: each event's own device time, so an operator's row does not
    count its kernels twice."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6


def busy_share(torch, step, n):
    """(ms per call of ``step``, device-busy share): the kernel time that
    torch.profiler sums over ``n`` calls, over the wall time of ``n``
    unprofiled calls.  The share is None if the profiler saw no device time."""
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
    busy = device_seconds(prof)
    return wall / n * 1e3, (busy / wall if busy else None)


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


def config3_pieces(torch, arrays, chains, depth, warmup, device, seed=13):
    """Config 3's pieces on ``device``: the data, the Kronecker metric and MAP,
    the lockstep NUTS kernel on the fused value+grad, a warmed-up state, and
    the map from whitened chunks to parameter space."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched
    from dropout_hamiltonian_montecarlo_tpu_torch.inference.warmup import run_warmup
    from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams
    from dropout_hamiltonian_montecarlo_tpu_torch.ops.kron_metric import (
        cached_gn_setup, make_whitened_fused_vag)

    Xn, yn = arrays
    k = int(yn.max()) + 1
    X = torch.from_numpy(Xn).to(device)
    yi = torch.from_numpy(yn.astype("int64")).to(device)
    y = torch.nn.functional.one_hot(yi, k).to(torch.float32)
    model = Softmax(dim=X.shape[1], n_classes=k, alpha=1.0)
    metric, _, qmap, _ = cached_gn_setup(X, y, model, alpha=1.0, newton_steps=60,
                                         cache_dir=None, n_classes=k)
    vag, _ = make_whitened_fused_vag(model, metric, qmap, (X, y))
    kernel = nuts_batched.build_batched_kernel(vag, max_tree_depth=depth)
    gen = torch.Generator(device=device).manual_seed(seed)
    e0 = {"weights": streams.randn((chains, X.shape[1], k), generator=gen, device=device),
          "bias": streams.randn((chains, k), generator=gen, device=device)}
    template = nuts_batched.batched_init(e0, vag)
    warm = run_warmup(kernel, template, warmup,
                      initial_step_size=torch.full((chains,), 0.1, device=device),
                      target_acceptance=0.65, adapt_mass=False, generator=gen)

    def to_param(pos_e):
        out = {kk: torch.empty_like(v) for kk, v in pos_e.items()}
        for c in range(chains):
            dq = metric.unwhiten({kk: v[c] for kk, v in pos_e.items()})
            for kk in out:
                out[kk][c] = qmap[kk] + dq[kk]
        return out

    return {"kernel": kernel, "template": template, "warm": warm, "to_param": to_param,
            "ones": {kk: torch.ones_like(v) for kk, v in e0.items()}, "e0": e0,
            "device": torch.device(device), "chains": chains, "seed": seed}


def phase_resume(torch, pieces, chunk, chunks, workdir, launch_counts, reset_counts):
    """Phase 13.  Returns (the uninterrupted run's draw buffer, a dict of
    what was measured, the launch counts of everything it ran)."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import sampling
    from dropout_hamiltonian_montecarlo_tpu_torch.io.checkpoint import save_checkpoint

    dev, chains = pieces["device"], pieces["chains"]
    kernel, warm, ones = pieces["kernel"], pieces["warm"], pieces["ones"]
    total = chunk * chunks

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(backend, num, states=None, step=None, **kw):
        gen = torch.Generator(device=dev).manual_seed(pieces["seed"])
        sync()
        t0 = time.perf_counter()
        out = sampling.sample_batched_streaming(
            kernel, warm.state if states is None else states,
            warm.step_size if step is None else step, ones, backend, num_samples=num,
            chunk_size=chunk, transform=pieces["to_param"], generator=gen, **kw)
        sync()
        return out, time.perf_counter() - t0

    reset_counts()
    run(sampling.DeviceBackend(chunk), chunk)       # untimed: the first chunk pays set-up
    # A0: uninterrupted, no checkpoint; A: uninterrupted, a checkpoint each chunk
    plain = sampling.DeviceBackend(total)
    _, plain_s = run(plain, total)
    a = sampling.DeviceBackend(total)
    (_, appended, _), ckpt_s = run(a, total, checkpoint_path=os.path.join(workdir, "a.ckpt"))
    if appended != total or a.num_draws() != total:
        fail(f"phase 13: the uninterrupted run appended {appended} of {total}")
    qa, qp = a.draws(), plain.draws()
    if not all(torch.equal(qa[k], qp[k]) for k in qa):
        fail("phase 13: the same run with and without a checkpoint file differs")
    del plain, qp
    t0 = time.perf_counter()
    for _ in range(3):
        save_checkpoint(os.path.join(workdir, "t.ckpt"), warm.state, seed=0, step=0,
                        extras={"step_size": warm.step_size, "inv_mass": ones})
    save_ms = (time.perf_counter() - t0) / 3 * 1e3

    # B: two chunks, then a resume with warmup skipped: template state and
    # placeholder step sizes, which the checkpoint's replace
    half = total // 2
    ckpt = os.path.join(workdir, "b.ckpt")
    b = sampling.DeviceBackend(total)
    run(b, half, checkpoint_path=ckpt)
    import numpy as np
    with np.load(ckpt) as z:
        counter, names = int(z["__step__"]), set(z.files)
    if counter != half or "__seed__" not in names or "extra.step_size::" not in names:
        fail(f"phase 13: the checkpoint's counter is {counter}, not {half}, or it lacks a key")
    first = dict(launch_counts)
    reset_counts()
    leaves_before = kernel.leaves_executed
    placeholder = torch.full((chains,), 99.0, device=dev)
    (_, appended, infos), _ = run(b, total, states=pieces["template"], step=placeholder,
                                  checkpoint_path=ckpt, resume=True)
    second = dict(launch_counts)
    leaves = kernel.leaves_executed - leaves_before
    if dev.type == "cuda" and second != {"grad": 0, "value_and_grad": leaves}:
        fail(f"phase 13: the resumed half launched {second}, its lockstep leaves are {leaves}")
    if appended != total or len(infos) != chunks - chunks // 2:
        fail(f"phase 13: the resume appended {appended}, ran {len(infos)} chunks")
    qb = b.draws()
    if not all(torch.equal(qb[k], qa[k]) for k in qa):
        worst = max(float((qb[k] - qa[k]).abs().max()) for k in qa)
        fail(f"phase 13: the resumed run differs from the uninterrupted one (max {worst:.3g})")
    with np.load(ckpt) as z:
        if int(z["__step__"]) != total:
            fail(f"phase 13: the final checkpoint's counter is {int(z['__step__'])}")
    del b, qb

    # a crash between an append and its checkpoint write
    reset_counts()
    ckpt = os.path.join(workdir, "c.ckpt")
    c = sampling.DeviceBackend(total)
    run(c, half, checkpoint_path=ckpt)
    c.append({k: torch.full((chunk,) + tuple(v.shape[:1] + v.shape[2:]), 1e9, device=dev)
              for k, v in qa.items()})
    if c.num_draws() != half + chunk:
        fail("phase 13: the crashed buffer does not hold the extra chunk")
    run(c, total, states=pieces["template"], step=placeholder, checkpoint_path=ckpt,
        resume=True)
    qc = c.draws()
    if c.num_draws() != total or not all(torch.equal(qc[k], qa[k]) for k in qa):
        fail("phase 13: the resume after a crash differs from the uninterrupted run")
    third = dict(launch_counts)
    counts = {k: first[k] + second[k] + third[k] for k in first}
    measured = {"chains": chains, "draws": total, "chunk": chunk,
                "s_per_chunk_no_checkpoint": round(plain_s / chunks, 4),
                "s_per_chunk_with_checkpoint": round(ckpt_s / chunks, 4),
                "checkpoint_write_ms": round(save_ms, 2),
                "checkpoint_bytes": os.path.getsize(os.path.join(workdir, "t.ckpt")),
                "resumed_half_value_and_grad_launches": second["value_and_grad"],
                "resumed_half_lockstep_leaves": leaves}
    return a, measured, counts


def buffer_diagnostics(torch, q, storage, device):
    """min / median ESS and max R-hat of a draw buffer, as the CLI computes
    them: on the device where the draws lie there, else blockwise."""
    from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics.ess import effective_sample_size
    from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics.rhat import split_rhat
    from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics.summary import (draw_diagnostics,
                                                                              median)

    if storage == "device":
        ess = torch.cat([effective_sample_size(q["weights"], block_size=512).reshape(-1),
                         effective_sample_size(q["bias"]).reshape(-1)])
        rh = torch.cat([split_rhat(q["weights"]).reshape(-1), split_rhat(q["bias"]).reshape(-1)])
    else:
        diag = draw_diagnostics(q, device)
        ess, rh = diag["ess"], diag["rhat"]
    return {"min_ess": float(ess.min()), "median_ess": float(median(ess)),
            "max_rhat": float(rh.max())}


def phase_draw_buffer(torch, pieces, chunk, chunks, reference):
    """Phase 14.  ``reference``: the draw buffer of phase 13's uninterrupted
    run (device storage).  Returns what was measured."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import sampling

    dev, total = pieces["device"], chunk * chunks
    cuda = dev.type == "cuda"
    nbytes = sampling.draw_bytes(pieces["chains"], total, pieces["e0"])
    out = {"draw_tensor_bytes": nbytes}
    ref = reference.draws()
    for storage, threshold in (("device", None), ("host", 1)):
        chosen = sampling.choose_draw_storage(nbytes, dev, threshold)
        if chosen != storage:
            fail(f"phase 14: threshold {threshold} chose {chosen} storage, not {storage}")
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            out[f"{storage}_allocated_before"] = torch.cuda.memory_allocated(dev)
        backend = sampling.DeviceBackend(total, storage=storage)
        gen = torch.Generator(device=dev).manual_seed(pieces["seed"])
        t0 = time.perf_counter()
        sampling.sample_batched_streaming(
            pieces["kernel"], pieces["warm"].state, pieces["warm"].step_size, pieces["ones"],
            backend, num_samples=total, chunk_size=chunk, transform=pieces["to_param"],
            generator=gen)
        q = backend.draws()
        if cuda:
            torch.cuda.synchronize(dev)
            out[f"{storage}_peak_allocated_sampling"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        out[f"{storage}_run_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        out[storage] = buffer_diagnostics(torch, q, storage, dev)
        out[f"{storage}_diag_s"] = round(time.perf_counter() - t0, 3)
        if cuda:
            out[f"{storage}_peak_allocated_diagnostics"] = torch.cuda.max_memory_allocated(dev)
            if storage == "host" and not all(v.is_pinned() and not v.is_cuda
                                              for v in q.values()):
                fail("phase 14: the host buffer is not pinned host memory")
        for k in ref:       # one chain at a time: no second copy on the device
            if not all(torch.equal(q[k][c].to(dev), ref[k][c]) for c in range(ref[k].shape[0])):
                fail(f"phase 14: the {storage} buffer's draws differ from phase 13's")
        del backend, q
    for key in ("min_ess", "median_ess", "max_rhat"):
        d, h = out["device"][key], out["host"][key]
        if not math.isfinite(h) or abs(h - d) > 1e-5 * abs(d):
            fail(f"phase 14: {key} is {h} from the host buffer, {d} from the device buffer")
    if cuda:
        # the buffer is ONE copy of the draw tensor: the device run's peak over
        # its start is the host run's (the chunk's temporaries and the
        # kernel's buffers) plus at most 1.25 draw tensors, not two
        extra = ((out["device_peak_allocated_sampling"] - out["device_allocated_before"])
                 - (out["host_peak_allocated_sampling"] - out["host_allocated_before"]))
        out["device_minus_host_peak_over_draw_bytes"] = round(extra / nbytes, 3)
        if not 0.4 <= extra / nbytes <= 1.25:
            fail(f"phase 14: the device buffer costs {extra} bytes of peak memory over the "
                 f"host buffer, the draw tensor is {nbytes}")
    return out


def phase_files(torch, cli, kron_metric, backend_mod, workdir, chains, depth, chunk):
    """Phase 15 (needs h5py).  Returns what was measured."""
    import h5py
    import numpy as np

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        return json.loads(out.getvalue().strip().splitlines()[-1])

    def read(path):
        with h5py.File(path, "r") as f:
            return {k: f[k][:] for k in ("weights", "bias")}

    # the time the file append adds per chunk
    spent = {"s": 0.0, "n": 0}
    inner = backend_mod.HDF5Backend.append

    def timed_append(self, positions):
        t0 = time.perf_counter()
        inner(self, positions)
        spent["s"] += time.perf_counter() - t0
        spent["n"] += 1

    device_args = [] if torch.cuda.is_available() else ["--device", "cpu"]
    common = ["mnist-nuts", "--chains", str(chains), "--warmup", "20", "--max-depth",
              str(depth), "--stream-chunk", str(chunk)] + device_args
    full, part = os.path.join(workdir, "full.h5"), os.path.join(workdir, "part.h5")
    ckpt = os.path.join(workdir, "part.ckpt")
    backend_mod.HDF5Backend.append = timed_append
    try:
        a = run(common + ["--samples", str(4 * chunk), "--save", full, "--checkpoint",
                          os.path.join(workdir, "full.ckpt")])
        run(common + ["--samples", str(2 * chunk), "--save", part, "--checkpoint", ckpt])
        b = run(common + ["--samples", str(4 * chunk), "--save", part, "--checkpoint", ckpt,
                          "--resume"])
    finally:
        backend_mod.HDF5Backend.append = inner
    fa, fb = read(full), read(part)
    for k in fa:
        if fa[k].shape[:2] != (4 * chunk, chains) or not np.array_equal(fa[k], fb[k]):
            fail(f"phase 15: {k} of the resumed file differs from the uninterrupted run's")
    if a["resumed"] or not b["resumed"] or b["warmup_s"] != 0.0:
        fail(f"phase 15: resumed flags {a['resumed']} / {b['resumed']}, warmup_s {b['warmup_s']}")
    for key in ("min_ess", "median_ess", "max_rhat"):
        if abs(b[key] - a[key]) > 1e-5 * abs(a[key]):
            fail(f"phase 15: {key} {b[key]} read back from the file, {a[key]} from the buffer")
    out = {"file_bytes": os.path.getsize(full),
           "append_s_per_chunk": round(spent["s"] / max(spent["n"], 1), 4),
           "appends": spent["n"], "uninterrupted": a, "resumed": b}

    # --data PATH on off-grid pixels (k/255 is not exact in bf16)
    rng = np.random.RandomState(15)
    n, d = 2000, 64
    yi = rng.randint(0, 10, n)
    centers = rng.randint(0, 200, (10, d))
    pixels = np.clip(centers[yi] + 25 * rng.randn(n, d), 0, 255).round()
    data = os.path.join(workdir, "mnist_train.h5")
    with h5py.File(data, "w") as f:
        f["X_train"] = (pixels / 255.0).astype(np.float32)
        f["y_train"] = np.eye(10, dtype=np.float32)[yi]
    seen = []
    split = kron_metric.split_bf16_input

    def capture(X):
        pieces = split(X)
        seen.append(pieces[1] is not None)
        return pieces

    kron_metric.split_bf16_input = capture
    try:
        line = run(["mnist-nuts", "--data", data, "--chains", "16", "--samples", "20",
                    "--warmup", "20", "--max-depth", "3"] + device_args)
    finally:
        kron_metric.split_bf16_input = split
    if torch.cuda.is_available() and seen != [True]:
        fail(f"phase 15: the off-grid file's X was split {seen}: no X_lo piece")
    if line["dataset"] != f"hdf5:{data}" or not line["train_accuracy"] > 0.85:
        fail(f"phase 15: --data gave dataset {line['dataset']}, train accuracy "
             f"{line['train_accuracy']}")
    out["data_file"] = line
    return out


# ---------------------------------------------------------------------------
# Phases 16-18: ranks started as subprocesses by torchrun
# ---------------------------------------------------------------------------


class RecordLeaves:
    """Patches ``nuts_batched.build_batched_kernel`` so that every kernel it
    builds keeps each call's per-chain tree sizes (on the device, read at the
    end): ``leaves()`` is (calls, chains)."""

    def __init__(self, torch, nuts_batched):
        self.torch, self.nb, self.calls = torch, nuts_batched, []

    def __enter__(self):
        inner, calls = self.nb.build_batched_kernel, self.calls
        self._inner = inner

        class Recorded:
            def __init__(self, kernel):
                self._kernel = kernel

            def __call__(self, *a, **kw):
                state, info = self._kernel(*a, **kw)
                calls.append(info.num_integration_steps.clone())
                return state, info

            def __getattr__(self, name):
                return getattr(self._kernel, name)

        self.nb.build_batched_kernel = lambda *a, **kw: Recorded(inner(*a, **kw))
        return self

    def __exit__(self, *exc):
        self.nb.build_batched_kernel = self._inner

    def leaves(self):
        return self.torch.stack(self.calls).cpu()


def chain_digests(torch, draws) -> list:
    """One sha256 a chain over the bytes of its draws (every leaf of
    ``draws``, chains leading): equal digests are equal draws, bit for bit."""
    import hashlib

    chains = next(iter(draws.values())).shape[0]
    out = []
    for c in range(chains):
        h = hashlib.sha256()
        for k in sorted(draws):
            h.update(draws[k][c].contiguous().cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def run_ranks(nproc: int, steps: list, workdir: str, timeout: float):
    """One torchrun launch of ``nproc`` ranks of this script's worker, in a
    process group of their own (killed on a timeout), running ``steps`` in
    turn; returns ({step name: each rank's JSON report}, the launch's
    seconds).  A failed rank fails the phase with the ranks' log."""
    import signal

    tag = f"ranks{nproc}"
    spec = os.path.join(workdir, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump(steps, f)
    log = os.path.join(workdir, f"{tag}.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), os.path.abspath(__file__), "--rank-worker", spec, "--out", workdir]
    # the ranks' BLAS threads as this process's (torchrun would give each rank
    # one): the host eigh of the metric set-up rounds by its thread count, and
    # the ranks are held bit for bit against runs made in this process
    threads = {} if "OMP_NUM_THREADS" in os.environ else {
        "OMP_NUM_THREADS": str(len(os.sched_getaffinity(0)))}
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                                env=dict(os.environ, **threads), start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(log) as f:
            tail = f.read().splitlines()[-60:]
        print("\n".join(tail), flush=True)
        fail(f"the {nproc}-rank launch of {[s['name'] for s in steps]} exited {rc} (log above)")
    reports = {}
    for step in steps:
        reports[step["name"]] = []
        for r in range(nproc):
            with open(os.path.join(workdir, f"{step['name']}_rank{r}.json")) as f:
                reports[step["name"]].append(json.load(f))
    return reports, seconds


def worker(spec: str, out: str) -> None:
    """One rank of phases 16-18 (started by ``run_ranks``): runs each step of
    the JSON list in ``spec`` in turn, in one process group, with the
    kernel's launch counts set to 0 just before the step and read just
    after, and writes ``<out>/<name>_rank<r>.json`` with them, the step's
    seconds, its seconds in the all-reduce and what its mode reports.  A
    step is {"name", "mode", "argv", "env", "profile"}; the modes: "bench"
    (``bench.main``; "profile" traces rank 0's sampling loop), "cli"
    (``cli.main``, with the lockstep tree sizes) and "dpvag" (phase 17's
    value+grad)."""
    import torch

    from dropout_hamiltonian_montecarlo_tpu_torch import bench, cli, full_f32_precision
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import mesh

    full_f32_precision()
    rank = int(os.environ["RANK"])
    cuda = torch.cuda.is_available()
    with open(spec) as f:
        steps = json.load(f)
    reduce_s = {"s": 0.0, "n": 0}
    inner_reduce = mesh.all_reduce_sum

    def timed_reduce(tensors, group):
        # the collective's seconds, the device work before it excluded
        tensors = list(tensors)
        if tensors and tensors[0].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = inner_reduce(tensors, group)
        if got and got[0].is_cuda:
            torch.cuda.synchronize()
        reduce_s["s"] += time.perf_counter() - t0
        reduce_s["n"] += 1
        return got

    mesh.all_reduce_sum = timed_reduce
    for step in steps:
        mode, argv, env = step["mode"], step["argv"], dict(step.get("env", {}))
        if step.get("profile") and rank == 0:
            env["BENCH_TRACE"] = os.path.join(out, f"trace_{step['name']}")
        before = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        report, record = {}, None
        reduce_s.update(s=0.0, n=0)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sg.reset_launch_counts()
        stdout = io.StringIO()
        if mode == "bench":
            with contextlib.redirect_stdout(stdout):
                record = bench.main(argv, keep_draws=True)
        elif mode == "cli":
            with RecordLeaves(torch, nuts_batched) as rec, contextlib.redirect_stdout(stdout):
                cli.main(argv)
            lines = stdout.getvalue().strip().splitlines()
            report["line"] = json.loads(lines[-1]) if lines else None
            if rec.calls:
                report["leaves"] = rec.leaves().tolist()
        elif mode == "dpvag":
            report.update(dp_value_and_grad_rank(torch, sg, argv, out))
        else:
            raise SystemExit(f"unknown worker mode {mode}")
        if cuda:
            torch.cuda.synchronize()
        report.update(rank=rank, seconds=time.perf_counter() - t0,
                      launches=dict(sg.launch_counts), reduce_s=reduce_s["s"],
                      reduces=reduce_s["n"], backend=torch.distributed.get_backend())
        if record is not None:
            draws = record.pop("draws")
            report.update(record=record, digests=chain_digests(torch, draws))
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        with open(os.path.join(out, f"{step['name']}_rank{rank}.json"), "w") as f:
            json.dump(report, f)
    mesh.all_reduce_sum = inner_reduce
    torch.distributed.destroy_process_group()


def dp_inputs(torch, device, n, d, k, c):
    """Phase 3's bench-shape inputs (seed 1) on ``device``."""
    if device == "cuda":
        return make_inputs(torch, n, d, k, c, 1, 0.05)
    g = torch.Generator().manual_seed(1)
    X = torch.randint(0, 256, (n, d), generator=g).float() / 256.0
    Y = torch.nn.functional.one_hot(torch.randint(0, k, (n,), generator=g), k).float()
    return X, Y, 0.05 * torch.randn((c, d, k), generator=g), 0.1 * torch.randn((c, k),
                                                                                 generator=g)


def dp_value_and_grad_rank(torch, sg, argv, out_dir):
    """Phase 17's value+grad on this rank's rows (argv: device backend n d k
    c): the fused kernel with include_prior=False, the all-reduce, the prior
    once.  Rank 0 saves the result beside its report."""
    from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import (
        init_distributed, local_device, make_layout, make_sharded_value_and_grad, shard_data)

    device, backend, (n, d, k, c) = argv[0], argv[1], map(int, argv[2:6])
    dev = local_device(device)
    init_distributed(backend=backend, device=dev)
    layout = make_layout(1, int(os.environ["WORLD_SIZE"]))
    X, Y, W, b = dp_inputs(torch, dev.type, n, d, k, c)
    vag = make_sharded_value_and_grad(Softmax(dim=d, n_classes=k, alpha=1.0), n, layout)
    local = shard_data((X, Y), layout)
    value, grads = vag({"weights": W, "bias": b}, local)
    out = {"local_rows": int(local[0].shape[0])}
    if dev.type == "cuda":
        from dropout_hamiltonian_montecarlo_tpu_torch.utils.profiling import cuda_time_ms

        out["ms_per_call_with_all_reduce"] = cuda_time_ms(
            lambda: vag({"weights": W, "bias": b}, local), 5, 1)
    if layout.rank == 0:
        torch.save({"value": value.cpu(), "weights": grads["weights"].cpu(),
                    "bias": grads["bias"].cpu()}, os.path.join(out_dir, "dpvag.pt"))
    return out


def launches_of(reports) -> dict:
    """The kernel launches of every rank of a run, summed."""
    return {k: sum(r["launches"][k] for r in reports) for k in ("value_and_grad", "grad")}


def add_launches(total: dict, counts: dict) -> None:
    for key in total:
        total[key] += counts[key]


def bench_env(chains, warmup, draws, dataset, shards) -> dict:
    return {"BENCH_CHAINS": str(chains), "BENCH_WARMUP": str(warmup),
            "BENCH_DRAWS": str(draws), "BENCH_L": str(L), "BENCH_TARGET_ACCEPT": "0.5",
            "BENCH_DATASET": dataset, "BENCH_CHAIN_SHARDS": str(shards)}


def nuts_argv(device, dataset, chains, nuts) -> list:
    """Phase 16's ``mnist-nuts --chain-shards 2``."""
    nw, nd, depth = nuts
    argv = ["mnist-nuts", "--chains", str(chains), "--samples", str(nd), "--warmup", str(nw),
            "--max-depth", str(depth), "--chain-shards", "2", "--device", device]
    return argv + (["--dataset", "digits"] if dataset == "digits" else [])


def rank_launches(workdir, smc_argv, device="cuda", dataset="mnist", chains=CHAINS,
                  warmup=WARMUP, draws=DRAWS, nuts=(NUTS_WARMUP, NUTS_DRAWS, NUTS_DEPTH),
                  dp_shape=(60000, 784, 10, CHAINS), sgmcmc_argv=None, nccl="nccl"):
    """The ranks of phases 16-18 in two torchrun launches, each running its
    steps in one process group: 2 ranks under gloo (NCCL takes one card a
    rank, and the two share the one card), then 1 rank under NCCL.  Returns
    ({step name: each rank's report}, {ranks: the launch's seconds})."""
    gloo = ["--dist-backend", "gloo"]
    smc_argv = list(smc_argv) + ["--shard-particles"]
    two = [{"name": "bench2", "mode": "bench", "argv": ["--device", device] + gloo,
            "env": bench_env(chains, warmup, draws, dataset, 2), "profile": True},
           {"name": "nuts2", "mode": "cli",
            "argv": nuts_argv(device, dataset, chains, nuts) + gloo},
           {"name": "dpvag2", "mode": "dpvag", "argv": [device, "gloo", *map(str, dp_shape)]}]
    if sgmcmc_argv is not None:
        two.append({"name": "sgmcmc2", "mode": "cli",
                    "argv": list(sgmcmc_argv) + ["--data-shards", "2"] + gloo})
    two.append({"name": "smc2", "mode": "cli", "argv": smc_argv + gloo})
    one = [{"name": "bench1", "mode": "bench",
            "argv": ["--device", device, "--dist-backend", nccl],
            "env": bench_env(chains, warmup, draws, dataset, 1)},
           {"name": "smc1", "mode": "cli", "argv": smc_argv + ["--dist-backend", nccl]}]
    reports, seconds = {}, {}
    for n, steps, timeout in ((2, two, 600), (1, one, 300)):
        got, seconds[n] = run_ranks(n, steps, workdir, timeout)
        reports.update(got)
    return reports, seconds


def phase_chain_shards(torch, bench, cli, nuts_batched, sg, ranks, unblocked, leaves6,
                       device="cuda", dataset="mnist", chains=CHAINS, warmup=WARMUP,
                       draws=DRAWS, nuts=(NUTS_WARMUP, NUTS_DRAWS, NUTS_DEPTH)):
    """Phase 16 on the ranks' reports (``rank_launches``).  ``unblocked``:
    phase 4's record with its draws (the same seed and settings, one
    process, all chains); ``leaves6``: phase 6's tree sizes.  Returns (what
    was measured, the launches of everything it ran)."""
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import RankLayout

    cuda = device == "cuda"
    out, total = {}, {"value_and_grad": 0, "grad": 0}

    def add(counts):
        add_launches(total, counts)

    want = {"grad": (warmup + draws) * (L - 1), "value_and_grad": warmup + draws + 2}

    # (a) the HMC headline on 2 ranks x chains / 2 (gloo: one card); rank 0's
    # sampling loop ran under the profiler, rank 1's did not
    two = ranks["bench2"]
    add(launches_of(two))
    rec = two[0]["record"]
    det = rec["detail"]
    out["two_ranks"] = {key: det[key] for key in (
        "chain_shards", "acceptance", "ess_median", "ess_min", "sample_seconds",
        "sample_seconds_per_rank", "kernel_launches_per_rank",
        "step_size_median")}
    out["two_ranks"].update(median_ess_per_sec=rec["value"], backend=two[0]["backend"],
                            seconds_per_rank=[round(r["seconds"], 2) for r in two])
    if det["chain_shards"] != 2 or not math.isfinite(rec["value"]):
        fail(f"phase 16: the 2-rank bench line: {json.dumps(det)}")
    if cuda and any(r["launches"] != want for r in two):
        fail(f"phase 16: launches per rank {[r['launches'] for r in two]} != {want}")

    # (b) the same seed in one process, block by block, through the sharded code
    blocks = []
    for r in range(2):
        sg.reset_launch_counts()
        record = bench.run(device=device, chains=chains, warmup=warmup, draws=draws,
                           num_integration_steps=L, target_accept=0.5, dataset=dataset,
                           layout=RankLayout(2, 1, r), keep_draws=True)
        if cuda and dict(sg.launch_counts) != want:
            fail(f"phase 16: block {r} launched {dict(sg.launch_counts)} != {want}")
        add(dict(sg.launch_counts))
        blocks.append(record)
    joined = {k: torch.cat([b["draws"][k] for b in blocks]) for k in blocks[0]["draws"]}
    same = [a == b for a, b in zip(chain_digests(torch, joined), two[0]["digests"])]
    out["two_ranks_equal_blockwise_chains"] = sum(same)
    if not all(same):
        fail(f"phase 16: the 2-rank draws differ from the blockwise one-process run's in "
             f"chains {[i for i, s in enumerate(same) if not s]}")

    # (c) against the unblocked one-process run (phase 4).  The kernel's
    # backward slices depend on C K, so 64-chain blocks round otherwise than
    # 128 and the trajectories part (phase 3 holds both shapes against plain).
    # Bounds that two runs of this posterior meet: acceptance within 0.05;
    # accept decisions differing at most as two independent samplers' would,
    # 2 p (1 - p), plus 0.05; the largest draw difference within 10 times
    # the largest coordinate sd; every coordinate's mean within 6 standard
    # errors of a difference of two independent means, sd sqrt(2 / min ESS)
    ref = unblocked["draws"]
    p = unblocked["detail"]["acceptance"]
    acc_blocks = 0.5 * sum(b["detail"]["acceptance"] for b in blocks)
    flips = joined["accepted"] != ref["accepted"]
    first = flips.any(dim=0).nonzero().flatten().tolist()
    diff, sd_max, mean_z = 0.0, 0.0, 0.0
    for k in ("weights", "bias"):
        a, u = joined[k].flatten(0, 1), ref[k].flatten(0, 1)
        sd = u.std(0)
        diff = max(diff, float((joined[k] - ref[k]).abs().max()))
        sd_max = max(sd_max, float(sd.max()))
        mean_z = max(mean_z, float(((a.mean(0) - u.mean(0)).abs() / sd).max()))
    ess = min(unblocked["detail"]["ess_min"], det["ess_min"])
    limits = {"acceptance_gap": 0.05, "accept_flip_frac": 2 * p * (1 - p) + 0.05,
              "max_abs_draw_diff": 10 * sd_max,
              "max_mean_diff_over_sd": 6 * math.sqrt(2 / ess)}
    got = {"acceptance_gap": abs(acc_blocks - p),
           "accept_flip_frac": float(flips.float().mean()),
           "max_abs_draw_diff": diff, "max_mean_diff_over_sd": mean_z}
    out["vs_unblocked"] = {
        "measured": got, "limits": limits, "accept_decisions_differing": int(flips.sum()),
        "of": int(flips.numel()), "first_draw_differing": first[0] if first else None,
        "acceptance_blockwise": acc_blocks, "acceptance_unblocked": p}
    if not all(math.isfinite(got[key]) and got[key] <= limits[key] for key in limits):
        fail(f"phase 16: blockwise against unblocked: {json.dumps(out['vs_unblocked'])}")
    del joined, blocks

    # (d) world size 1 under NCCL: all chains in one rank = phase 4, bit for bit
    one = ranks["bench1"]
    add(launches_of(one))
    out["world_1"] = {"backend": one[0]["backend"], "seconds": round(one[0]["seconds"], 2)}
    ref_digests = chain_digests(torch, ref)
    out["world_1"]["equal_unblocked_chains"] = sum(
        a == b for a, b in zip(one[0]["digests"], ref_digests))
    if one[0]["digests"] != ref_digests or (cuda and one[0]["launches"] != want):
        fail(f"phase 16: world size 1 under {one[0]['backend']} differs from phase 4 "
             f"({out['world_1']['equal_unblocked_chains']} of {chains} chains equal, "
             f"launches {one[0]['launches']})")

    # (e) mnist-nuts --chain-shards 2 against the blockwise one-process run
    cranks = ranks["nuts2"]
    add(launches_of(cranks))
    line = cranks[0]["line"]
    two_leaves = torch.cat([torch.tensor(r["leaves"]) for r in cranks], dim=1)
    argv = nuts_argv(device, dataset, chains, nuts)
    inner_join = cli._join
    parts = []
    try:
        for r in range(2):
            cli._join = lambda args, *a, r=r, **kw: (torch.device(device), RankLayout(2, 1, r))
            sg.reset_launch_counts()
            with RecordLeaves(torch, nuts_batched) as rec, contextlib.redirect_stdout(
                    io.StringIO()):
                cli.main(argv)
            add(dict(sg.launch_counts))
            parts.append(rec.leaves())
    finally:
        cli._join = inner_join
    blockwise = torch.cat(parts, dim=1)
    out["cli"] = {key: line[key] for key in ("chain_shards", "min_ess", "median_ess",
                                             "max_rhat", "train_accuracy",
                                             "predictive_accuracy", "mean_leaves_per_draw",
                                             "run_s", "warmup_s")}
    out["cli"]["seconds_per_rank"] = [round(r["seconds"], 2) for r in cranks]
    out["cli"]["launches_per_rank"] = [r["launches"] for r in cranks]
    out["cli"]["tree_sizes_equal_blockwise"] = bool(torch.equal(two_leaves, blockwise))
    if leaves6 is not None and leaves6.shape == two_leaves.shape:
        out["cli"]["tree_sizes_equal_unblocked_frac"] = float(
            (two_leaves == leaves6).float().mean())
    if not torch.equal(two_leaves, blockwise):
        fail(f"phase 16: --chain-shards 2 tree sizes differ from the blockwise one-process "
             f"run's at {int((two_leaves != blockwise).sum())} of {two_leaves.numel()} "
             f"(chain, step)")
    if line["chain_shards"] != 2 or not math.isfinite(line["max_rhat"]) or not min(
            line["train_accuracy"], line["predictive_accuracy"]) > 0.85:
        fail(f"phase 16: the --chain-shards 2 line: {json.dumps(line)}")
    return out, total


def phase_data_parallel(torch, sg, ranks, workdir, mnist, device="cuda",
                        shape=(60000, 784, 10, CHAINS), width=(784, 256, 10), steps=20,
                        sgmcmc_steps=DP_STEPS):
    """Phase 17 on the ranks' reports (``rank_launches``).  Returns (what was
    measured, the launches of everything it ran)."""
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgmcmc
    from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams
    from dropout_hamiltonian_montecarlo_tpu_torch.parallel import (
        RankLayout, make_sharded_value_and_grad, run_sgmcmc_data_parallel)

    cuda = device == "cuda"
    out, total = {}, {"value_and_grad": 0, "grad": 0}

    def add(counts):
        add_launches(total, counts)

    # (a) the full-batch value+grad over 2 ranks of n / 2 rows
    n, d, k, c = shape
    dp = ranks["dpvag2"]
    add(launches_of(dp))
    got = torch.load(os.path.join(workdir, "dpvag.pt"))
    X, Y, W, b = dp_inputs(torch, device, n, d, k, c)
    sg.reset_launch_counts()
    v, gw, gb = sg.softmax_value_and_grad(X, Y, W, b, 1.0)
    add(dict(sg.launch_counts))
    errs = {"value": float((got["value"] - v.cpu()).abs().max())}
    for name, mine, ref in (("weights", got["weights"], gw.cpu()),
                            ("bias", got["bias"], gb.cpu())):
        gmax = float(ref.abs().max())
        errs[name] = float((mine - ref).abs().max())
        bad = (mine - ref).abs() > GRAD_ATOL_FRAC * gmax + GRAD_RTOL * ref.abs()
        if bool(bad.any()):
            fail(f"phase 17: the 2-rank gradient {name} differs in {int(bad.sum())} elements "
                 f"(max {errs[name]:.3g}, max|g| {gmax:.4g})")
    if errs["value"] > VALUE_ATOL:
        fail(f"phase 17: the 2-rank value is {errs['value']:.4g} nat off")
    out["value_and_grad"] = {"errors": errs, "local_rows": [r["local_rows"] for r in dp],
                             "launches_per_rank": [r["launches"] for r in dp],
                             "seconds_per_rank": [round(r["seconds"], 2) for r in dp],
                             "ms_per_call_with_all_reduce": [
                                 r.get("ms_per_call_with_all_reduce") for r in dp]}
    if cuda and any(r["launches"]["value_and_grad"] < 1 for r in dp):
        fail(f"phase 17: a rank did not launch the kernel: {[r['launches'] for r in dp]}")
    del X, Y, W, b, got

    # (b) mnist-mlp-sgmcmc --data-shards 2
    if "sgmcmc2" in ranks:
        sranks = ranks["sgmcmc2"]
        add(launches_of(sranks))
        line = sranks[0]["line"]
        out["sgmcmc"] = {key: line[key] for key in (
            "data_shards", "dropout", "train_accuracy", "predictive_accuracy",
            "predictive_nll", "logdensity_rhat", "elapsed_s", "steps_per_sec", "sgd_init_s")}
        steps_run = sgmcmc_steps
        out["sgmcmc"]["seconds_per_rank"] = [round(r["seconds"], 2) for r in sranks]
        out["sgmcmc"]["all_reduce_s_per_step"] = [round(r["reduce_s"] / steps_run, 6)
                                                  for r in sranks]
        out["sgmcmc"]["all_reduces_per_step"] = [r["reduces"] / steps_run for r in sranks]
        check_finite(line, ("train_accuracy", "predictive_accuracy", "predictive_nll",
                            "min_ess", "logdensity_ess", "elapsed_s"))
        if line["data_shards"] != 2 or line["dropout"] is not True:
            fail(f"phase 17: the --data-shards 2 line: {json.dumps(line)}")
        if any(r["launches"] != {"value_and_grad": 0, "grad": 0} for r in sranks):
            fail(f"phase 17: config 4 launched the fused kernel: "
                 f"{[r['launches'] for r in sranks]}")

    # (c) one data shard through the data-parallel driver = run_sgmcmc_chains
    Xn, yn = mnist
    dim, hidden, classes = width
    Xd = torch.from_numpy(Xn).to(device)
    Yd = torch.nn.functional.one_hot(torch.from_numpy(yn.astype("int64")).to(device),
                                     classes).float()
    model = DropoutMLP(dim=dim, hidden=hidden, n_classes=classes, alpha=1.0, p_drop=0.1)
    gen = torch.Generator(device=device).manual_seed(0)
    one = [model.init_params(gen, device) for _ in range(SGMCMC_CHAINS)]
    pos = {kk: torch.stack([p[kk] for p in one]) for kk in one[0]}
    n_rows = Xd.shape[0]
    run = dict(batch_size=1024, num_steps=steps,
               step_size_schedule=sgmcmc.constant_schedule(1e-5), collect_every=5)
    ref = sgmcmc.run_sgmcmc_chains(
        sgmcmc.build_sghmc_kernel(model.make_batched_logdensity(data_size=n_rows, dropout=True),
                                  keyed=True),
        sgmcmc.sghmc_init(pos), SGMCMC_CHAINS, (Xd, Yd),
        generator=streams.block_generator(5, device), **run)
    lay = RankLayout(1, 1, 0)
    dp = run_sgmcmc_data_parallel(
        sgmcmc.build_sghmc_kernel(keyed=True, value_and_grad_fn=make_sharded_value_and_grad(
            model, n_rows, lay, keyed=True)),
        sgmcmc.sghmc_init(pos), SGMCMC_CHAINS, (Xd, Yd), lay,
        generator=streams.block_generator(5, device), **run)
    equal = all(torch.equal(dp[1][kk], ref[1][kk]) for kk in ref[1])
    out["one_data_shard_equals_run_sgmcmc_chains"] = equal
    if not equal:
        fail("phase 17: one data shard differs from run_sgmcmc_chains")
    return out, total


def phase_particles(ranks, reference):
    """Phase 18 on the ranks' reports (``rank_launches``): ``plantvillage-smc
    --shard-particles`` against ``reference``, the one-process line of the
    same seed: at world size 1 (NCCL on the card) it must be that line, bit
    for bit; on 2 ranks (gloo), the same ladder length and evidence.  Returns
    (what was measured, the launches of both runs)."""
    keys = ("num_stages", "log_evidence", "predictive_accuracy", "elapsed_s")
    out = {"one_process": {key: reference[key] for key in keys}}
    total = {"value_and_grad": 0, "grad": 0}
    for n in (1, 2):
        reports = ranks[f"smc{n}"]
        line = reports[0]["line"]
        got = {key: line[key] for key in keys}
        got.update(seconds_per_rank=[round(r["seconds"], 2) for r in reports],
                   backend=reports[0]["backend"],
                   launches_per_rank=[r["launches"] for r in reports])
        out[f"{n}_ranks"] = got
        add_launches(total, launches_of(reports))
        if line["shard_particles"] is not True or not line["predictive_accuracy"] >= 0.99:
            fail(f"phase 18: {json.dumps(out)}")
    # one rank: the gathers copy, the ladder is the one-process code
    if any(out["1_ranks"][key] != reference[key] for key in keys[:3]):
        fail(f"phase 18: one rank is not the one-process run: {json.dumps(out)}")
    # two ranks: 128-particle blocks round their GEMMs otherwise than 256
    # (cuBLAS picks its kernels by shape), so the evidence moves in its last
    # digits; on the card this seed kept its 38 stages with the evidence 0.18
    # nat (0.024%) off in every whole run.  Asked: the same stage count, the
    # evidence within 0.1%
    two = out["2_ranks"]
    out["log_evidence_gap"] = abs(two["log_evidence"] - reference["log_evidence"])
    if (two["num_stages"] != reference["num_stages"]
            or out["log_evidence_gap"] > 1e-3 * abs(reference["log_evidence"])):
        fail(f"phase 18: two ranks against the one-process run: {json.dumps(out)}")
    return out, total


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from dropout_hamiltonian_montecarlo_tpu_torch import bench, cli, full_f32_precision
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import (metropolis, nuts_batched,
                                                                    sampling, sgmcmc, smc, vi)
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
    read_mnist = datasets.mnist
    datasets.mnist = lambda path=None, split="train": (
        mnist_arrays if path is None and split == "train" else read_mnist(path, split))

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
    # the shapes of the sharded phases: a 64-chain block of phase 16 (C K =
    # 640 sets the backward's slices otherwise than 1280) and phase 17's
    # 30,000-row data shard, whose call leaves the prior out.  Launches made
    # here to compare are not the path's: phase 4 counts from zero
    sharded = {}
    for label, shape, prior in (("N=60000,D=784,K=10,C=64", (60000, 784, 10, 64), True),
                                ("N=30000,D=784,K=10,C=128,include_prior=False",
                                 (30000, 784, 10, 128), False)):
        X, Y, W, b = make_inputs(torch, *shape, 1, 0.05)
        sharded[label] = compare(torch, sg, X, Y, W, b, alpha, sg.split_bf16_input(X),
                                 include_prior=prior)
    del X, Y, W, b
    print("phase 3 kernel vs plain at the sharded phases' shapes, errors: "
          + json.dumps(sharded), flush=True)
    stages = {}
    for name, full in (("value+grad", True), ("grad-only", False)):
        call = sg.KernelCall(split, Yb, Wb, bb, with_value=full)
        stages[name] = {st: cuda_time_ms(getattr(call, st), 10, 2)
                        for st in ("forward", "backward", "finish")}
        stages[name].update(forward_items=call.n_items, forward_blocks=call.grid)
    # the persistent forward's engagement: one counted call of each variant
    sg.reset_launch_counts()
    for full in (True, False):
        sg.softmax_value_and_grad(Xb, Yb, Wb, bb, alpha, fwd_full=full, x_split=split)
    overlapped = sg.forward_items_overlapped
    if overlapped != sum(st["forward_items"] - st["forward_blocks"] for st in stages.values()):
        fail(f"forward_items_overlapped {overlapped} != items - blocks of the two calls")
    print("phase 3 ms per stage: " + json.dumps(stages)
          + f"; forward_items_overlapped {overlapped} (one call of each variant)", flush=True)
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
                       num_integration_steps=L, target_accept=0.5, dataset="mnist",
                       keep_draws=True)
    torch.cuda.synchronize()
    counts = dict(sg.launch_counts)
    # the draws stay for phase 16, which holds the sharded runs against them
    unblocked = {"draws": result.pop("draws"), "detail": result["detail"]}
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
    with RecordLeaves(torch, nuts_batched) as leaves6, contextlib.redirect_stdout(out):
        cli.main(["mnist-nuts", "--chains", str(CHAINS), "--samples", str(NUTS_DRAWS),
                  "--warmup", str(NUTS_WARMUP), "--max-depth", str(NUTS_DEPTH)])
    leaves6 = leaves6.leaves()
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
    mean_atol, cov_atol = 0.1 * widen, 0.15 * widen
    ess_floor, rhat_cap = 0.5 * 4 * SMALL_DRAWS, 1.02
    for extra in ([], ["--nuts"]):
        line, agg, seen = run_cli(torch, cli, sampling, ["mvn-hmc", "--chains", "4",
                                                         "--samples", str(SMALL_DRAWS)] + extra)
        post = seen["post"]
        rate = draw_rate(torch, seen, 300 + SMALL_DRAWS)
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
        if mutation == "hmc":
            smc_reference = agg         # phase 18 shards the same run
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

    # ---- 13. resume on the card, full width ----------------------------------
    with tempfile.TemporaryDirectory() as workdir:
        sg.reset_launch_counts()
        pieces = config3_pieces(torch, mnist_arrays, CHAINS, NUTS_DEPTH, RESUME_WARMUP, "cuda")
        torch.cuda.synchronize()
        add(dict(sg.launch_counts))
        reference, measured, counts = phase_resume(
            torch, pieces, RESUME_CHUNK, RESUME_CHUNKS, workdir, sg.launch_counts,
            sg.reset_launch_counts)
        add(counts)
        print(f"phase 13 resume: B (2 chunks, resumed to 4, warmup skipped) and the resume "
              f"after a crash equal A bit for bit; {json.dumps(measured)}; launch counts "
              f"{counts}; {smi.splitlines()[0]}", flush=True)
        phase_seconds("phase 13")

        # ---- 14. the draw buffer on the device and in pinned host memory ------
        sg.reset_launch_counts()
        sizes = phase_draw_buffer(torch, pieces, RESUME_CHUNK, RESUME_CHUNKS, reference)
        torch.cuda.synchronize()
        counts = dict(sg.launch_counts)
        add(counts)
        if counts["value_and_grad"] < 2 * RESUME_CHUNK * RESUME_CHUNKS:
            fail(f"phase 14 kernel launches {counts}")
        print(f"phase 14 draw buffer: {json.dumps(sizes)}; launch counts {counts}; "
              f"{smi.splitlines()[0]}", flush=True)
        del reference, pieces
        torch.cuda.empty_cache()
        phase_seconds("phase 14")

        # ---- 15. files, where h5py imports ------------------------------------
        try:
            import h5py  # noqa: F401
            have_h5py = True
        except ImportError:
            have_h5py = False
        print(f"phase 15: h5py {'imports' if have_h5py else 'does not import'} on this "
              f"machine", flush=True)
        if have_h5py:
            from dropout_hamiltonian_montecarlo_tpu_torch.io import backend as backend_mod
            from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric

            sg.reset_launch_counts()
            files = phase_files(torch, cli, kron_metric, backend_mod, workdir, CHAINS,
                                NUTS_DEPTH, RESUME_CHUNK)
            torch.cuda.synchronize()
            counts = dict(sg.launch_counts)
            add(counts)
            if counts["grad"] != 0 or counts["value_and_grad"] < 8 * RESUME_CHUNK:
                fail(f"phase 15 kernel launches {counts}")
            print(f"phase 15 files: the resumed file equals the uninterrupted run's bit for "
                  f"bit; {json.dumps(files)}; launch counts {counts}; {smi.splitlines()[0]}",
                  flush=True)
            phase_seconds("phase 15")
        else:
            print("phase 15 was not run: it needs h5py (phases 13-14 hold the resume and "
                  "the draw buffer without a file)", flush=True)

    # ---- 16-18. ranks as processes under torchrun -----------------------------
    with tempfile.TemporaryDirectory() as workdir:
        ranks, launch_s = rank_launches(
            workdir, smc_common, sgmcmc_argv=[
                "mnist-mlp-sgmcmc", "--chains", str(SGMCMC_CHAINS), "--num-steps",
                str(DP_STEPS), "--burnin-steps", str(DP_STEPS // 3), "--collect-every", "10",
                "--sgd-init-steps", str(DP_SGD_STEPS)])
        print("phases 16-18 ranks: seconds a launch " + json.dumps(launch_s)
              + ", seconds a step and rank " + json.dumps(
                  {name: [round(r["seconds"], 2) for r in reports]
                   for name, reports in ranks.items()}), flush=True)
        phase_seconds("phases 16-18 rank launches")

        sg.reset_launch_counts()
        measured, counts = phase_chain_shards(torch, bench, cli, nuts_batched, sg, ranks,
                                              unblocked, leaves6)
        add(counts)
        del unblocked
        torch.cuda.empty_cache()
        print(f"phase 16 chain shards: {json.dumps(measured)}; launch counts {counts}; "
              f"{smi.splitlines()[0]}", flush=True)
        phase_seconds("phase 16")

        measured, counts = phase_data_parallel(torch, sg, ranks, workdir, mnist_arrays)
        add(counts)
        torch.cuda.empty_cache()
        print(f"phase 17 data parallel: {json.dumps(measured)}; launch counts {counts}; "
              f"{smi.splitlines()[0]}", flush=True)
        phase_seconds("phase 17")

        measured, counts = phase_particles(ranks, smc_reference)
        add(counts)
        print(f"phase 18 particle shards: {json.dumps(measured)}; launch counts {counts}; "
              f"{smi.splitlines()[0]}", flush=True)
        phase_seconds("phase 18")

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
    if len(sys.argv) > 1 and sys.argv[1] == "--rank-worker":
        # the ranks of phases 16-18: chip_smoke.py --rank-worker STEPS.json --out DIR
        worker(sys.argv[2], sys.argv[4])
    else:
        main()
    sys.exit(0)
