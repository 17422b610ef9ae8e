"""Sampler loop ``sghmc``: SGHMC over the keyed-dropout MLP, many chains at
once (the port's ``inference/sgmcmc.py::build_sghmc_kernel(keyed=True)`` over
``models/mlp.py::DropoutMLP.make_batched_logdensity(dropout=True)``, run by
``run_sgmcmc_chains``): each chain gathers its own minibatch (uniform rows
with replacement) and draws fresh dropout masks every step.

Set-up: the data (from the seed), the SGD warm start on one chain
(``inference/sgd.py::fit``), the chains jittered around it, and one short
chunk that warms the window's own calls.  A chunk of the window is one call
of ``run_sgmcmc_chains``.  On the steps the capture plan names, the harness
draws the step's random numbers with the kernel's own ``draw`` (the kernel
draws the same when left to itself) and keeps the state before and after,
the minibatch, the masks, the noise and the gradient the log density
received (a hook on its inputs), for the check after the window.

Traffic keys: chains, batch_size, collect_every, chunk_steps, capture_span,
capture_draws, trace_skip_chunks, trace_chunks."""

from __future__ import annotations

import functools
import time
from types import SimpleNamespace

import torch

from perfbench.yardstick import data, flops, seeds


def _gen(ctx, tag):
    g = torch.Generator(device=ctx.device)
    g.manual_seed(seeds.derive(ctx.seed, tag))
    return g


class SGHMCSession:
    span_names = ("perfbench.sghmc_step",)

    def __init__(self, ctx):
        from dropout_hamiltonian_montecarlo_tpu_torch import full_f32_precision
        from dropout_hamiltonian_montecarlo_tpu_torch.inference import sgd, sgmcmc
        from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.sgmcmc = ctx, sgmcmc
        full_f32_precision()
        if ctx.control:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        n, d, k, h = (int(cfg[key]) for key in ("n_train", "dim", "n_classes", "hidden"))
        X, yi = data.synthetic_mnist(ctx.seed, dev, n, d, k)
        Y = torch.nn.functional.one_hot(yi, k).to(torch.float32)
        self.X, self.Y = X, Y
        model = DropoutMLP(dim=d, hidden=h, n_classes=k, alpha=float(cfg["alpha"]),
                           p_drop=float(cfg["p_drop"]))
        base = model.make_batched_logdensity(data_size=n, dropout=True)
        self.grads = None

        def logdensity(params, batch, masks):
            if self.grads is not None:
                for name, leaf in params.items():
                    if leaf.requires_grad:
                        leaf.register_hook(functools.partial(self._keep_grad, name))
            return base(params, batch, masks)

        logdensity.chain_batched = True
        logdensity.draw_masks = base.draw_masks
        self.kernel = sgmcmc.build_sghmc_kernel(logdensity, friction=float(cfg["friction"]),
                                                keyed=True)
        self.step_size = float(cfg["step_size"])
        self.schedule = sgmcmc.constant_schedule(self.step_size)

        c, bsz = int(tr["chains"]), int(tr["batch_size"])
        self.chains, self.batch_size = c, bsz
        self.collect_every = int(tr["collect_every"])
        self.chunk_steps = int(tr["chunk_steps"])
        self.flop_per_step = flops.mlp_row_flop((d, h, h, k)) * bsz * c
        self.steps = 0
        self.timings = {}

        t0 = time.perf_counter()
        params0 = {key: v[None] for key, v in
                   model.init_params(_gen(ctx, seeds.INIT), dev).items()}
        if int(cfg["sgd_init_steps"]) > 0:
            sgd_kernel = sgd.build_sgd_kernel(model.make_batched_logdensity(data_size=n))
            state, _ = sgd.fit(sgd_kernel, sgd.sgd_init(params0), (X, Y), batch_size=bsz,
                               num_steps=int(cfg["sgd_init_steps"]),
                               step_size=float(cfg["sgd_step_size"]),
                               generator=_gen(ctx, seeds.SGD))
            params0 = state.position
        jit = _gen(ctx, seeds.JITTER)
        positions = {key: v.expand((c,) + v.shape[1:])
                     + float(cfg["chain_jitter"])
                     * torch.randn((c,) + v.shape[1:], generator=jit, device=dev)
                     for key, v in params0.items()}
        self.state = sgmcmc.sghmc_init(positions)
        self.gen = _gen(ctx, seeds.SAMPLE)
        self.capturing, self.step_index, self.chunk_first = False, 0, -1
        self.captures, self.last_chunk_capture = [], None
        self._run(self.collect_every)                 # warms the window's own calls
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings["warmup_s"] = time.perf_counter() - t0
        self.step_index, self.capturing = 0, True
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)

    def _keep_grad(self, name, g):
        self.grads[name] = g.detach().clone()

    # ---- the kernel handed to the run loop ---------------------------------

    def step(self, state, batch, step_size, *, draws=None, generator=None):
        i = self.step_index
        self.step_index += 1
        with self.ctx.spans("perfbench.sghmc_step"):
            if not (self.capturing and (i in self.ctx.capture_at or i == self.chunk_first)):
                return self.kernel(state, batch, step_size, draws=draws, generator=generator)
            draws = self.kernel.draw(state, batch, generator)
            self.grads = {}
            new, info = self.kernel(state, batch, step_size, draws=draws, generator=generator)
            cap = SimpleNamespace(
                index=i, q=_clone(state.position), v=_clone(state.momentum), batch=batch,
                masks=draws.masks, noise=draws.noise, grads=self.grads,
                q_new=_clone(new.position), v_new=_clone(new.momentum),
                value_new=new.logdensity.clone(), step_size=self.step_size)
            self.grads = None
            if i in self.ctx.capture_at:
                self.captures.append(cap)
            else:
                self.last_chunk_capture = cap
            return new, info

    # ---- the window ----------------------------------------------------------

    def _run(self, steps: int):
        self.state, _, _ = self.sgmcmc.run_sgmcmc_chains(
            self.step, self.state, self.chains, (self.X, self.Y), batch_size=self.batch_size,
            num_steps=steps, step_size_schedule=self.schedule,
            collect_every=self.collect_every, burnin_steps=0, generator=self.gen)

    def chunk(self) -> int:
        self.chunk_first = self.step_index
        self._run(self.chunk_steps)
        self.steps += self.chunk_steps
        finite = torch.isfinite(self.state.logdensity)
        for v in self.state.position.values():
            finite &= torch.isfinite(v).flatten(1).all(dim=1)
        self.bad += (~finite).sum() * self.chunk_steps
        return self.chains * self.chunk_steps

    def work_flop(self) -> float:
        return self.steps * self.flop_per_step

    def close(self) -> dict:
        return {"chains": self.chains, "draws_per_chain": self.steps, "ess": None,
                "failed": int(self.bad), "timings": self.timings}

    def check(self, reference) -> dict:
        caps = list(self.captures)
        if self.last_chunk_capture is not None:
            caps.append(self.last_chunk_capture)
        cfg = self.ctx.config
        return reference.check_sghmc(caps, self.X, self.Y, n_data=int(cfg["n_train"]),
                                     alpha=float(cfg["alpha"]), p_drop=float(cfg["p_drop"]),
                                     friction=float(cfg["friction"]))


def _clone(d):
    return {k: v.detach().clone() for k, v in d.items()}


def prepare(ctx):
    return SGHMCSession(ctx)
