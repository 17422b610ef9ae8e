"""The sampler loop of the softmax cells: chain-batched HMC or lockstep NUTS
in the whitened coordinates of the port's Kronecker Gauss-Newton metric,
with the gauge Gibbs move after every draw.

Set-up runs the port's path as its bench does: the data (from the seed),
``ops/kron_metric.py::shared_gn_setup`` (no cache), the whitened fused
value+grad, the sampler's kernel, ``inference/warmup.py::run_warmup``
(dual averaging, no mass adaptation) and one short chunk that warms the
window's own calls.  A chunk of the window is one call of
``parallel/chains.py::sample_batched_sharded`` with the gauge Gibbs move as
its ``post_step``.

The harness hands the program its callables wrapped: the value+grad and
grad-only functions (spans ``perfbench.vag`` / ``perfbench.grad`` in a
traced run, and a count of calls), the kernel step and the Gibbs move.  On
the iterations the capture plan names, the wrappers keep the step's inputs
and outputs (the state before, every value+grad call's position and
outputs, the state after the step with its accept decisions, the state
after the Gibbs move) for the check, which runs after the window.  There
the harness also draws the step's and the Gibbs move's random numbers
itself, with the program's own draw functions in the order the kernel and
the move draw them (so the stream is the one they would use), hands them in
and keeps them: the momentum and the MH uniforms (HMC), the momentum,
directions and leaf and subtree uniforms (NUTS), the gauge normals."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from ..yardstick import data, ess as ess_mod, flops, seeds


def _clone(d):
    return {k: v.detach().clone() for k, v in d.items()}


def _state(s):
    return SimpleNamespace(position=_clone(s.position), logdensity=s.logdensity.clone(),
                           grad=_clone(s.logdensity_grad))


class WhitenedSession:
    span_names = ("perfbench.vag", "perfbench.grad")

    def __init__(self, ctx, sampler: str):
        from dropout_hamiltonian_montecarlo_tpu_torch import full_f32_precision
        from dropout_hamiltonian_montecarlo_tpu_torch.inference import (hmc, nuts_batched,
                                                                        warmup)
        from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax
        from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.sampler = ctx, sampler
        full_f32_precision()
        if ctx.control:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        n, d, k = int(cfg["n_train"]), int(cfg["dim"]), int(cfg["n_classes"])
        self.alpha = float(cfg["alpha"])
        X, yi = data.synthetic_mnist(ctx.seed, dev, n, d, k)
        Y = torch.nn.functional.one_hot(yi, k).to(torch.float32)
        self.X, self.Y = X, Y
        model = Softmax(dim=d, n_classes=k, alpha=self.alpha)
        self.init_seed = seeds.derive(ctx.seed, seeds.INIT)
        metric, aux, qmap, _ = kron_metric.shared_gn_setup(
            X, Y, model, alpha=self.alpha, newton_steps=int(cfg["newton_steps"]),
            cache_dir=None, n_classes=k, seed=self.init_seed)
        self.metric, self.qmap = metric, qmap
        self.timings = {"gn_s": float(sum(aux["timings"].values()))}
        vag, grad = kron_metric.make_whitened_fused_vag(model, metric, qmap, (X, Y),
                                                        use_kernel=not ctx.control)
        self._vag, self._grad = vag, grad

        c = int(tr["chains"])
        self.chains = c
        self.flop_per_call = flops.softmax_vag_flop(n, d, k, c)
        self.vag_bound_s = flops.softmax_vag_bound_s(n, d, k, c)
        self.calls = 0
        self.capture = None
        self.captures, self.last_chunk_capture = [], None
        self.capturing = False
        self.draw_index = 0
        self.chunk_first = -1

        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seeds.derive(ctx.seed, seeds.SAMPLE))
        e0 = {"weights": torch.randn((c, d, k), generator=self.gen, device=dev),
              "bias": torch.randn((c, k), generator=self.gen, device=dev)}
        if sampler == "nuts":
            self.kernel = nuts_batched.build_batched_kernel(
                self.vag, max_tree_depth=int(tr["max_tree_depth"]))
            init = nuts_batched.batched_init
        else:
            self.kernel = hmc.build_batched_kernel(self.vag, int(tr["num_integration_steps"]),
                                                   grad_fn=self.grad)
            init = hmc.batched_init
        t0 = time.perf_counter()
        warm = warmup.run_warmup(self.kernel, init(e0, self.vag), int(tr["warmup_steps"]),
                                 initial_step_size=torch.full(
                                     (c,), float(tr["initial_step_size"]), device=dev),
                                 target_acceptance=float(tr["target_accept"]),
                                 adapt_mass=False, generator=self.gen)
        self.state = init(warm.state.position, self.vag)
        self.step_size, self.inv_mass = warm.step_size, warm.inv_mass
        self.gibbs_fn = kron_metric.make_whitened_gauge_gibbs(metric, aux, qmap)
        self.chunk_draws = int(tr["chunk_draws"])
        self._run(2)                                  # warms the window's own calls
        self.draw_index = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings["warmup_s"] = time.perf_counter() - t0
        self.calls = 0
        self.leaves0 = getattr(self.kernel, "leaves_executed", 0)
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        # the window's draws go into slabs allocated here, so that keeping
        # them allocates nothing while the window runs
        self.slab_draws = int(tr["draws_per_slab"])
        self.slabs = []
        self._new_slab()
        self.capturing = True

    # ---- the callables handed to the program ------------------------------

    def vag(self, E):
        with self.ctx.spans("perfbench.vag"):
            value, G = self._vag(E)
        self.calls += 1
        if self.capture is not None:
            self.capture.calls.append((_clone(E), value.clone(), _clone(G)))
        return value, G

    def grad(self, E):
        with self.ctx.spans("perfbench.grad"):
            G = self._grad(E)
        self.calls += 1
        if self.capture is not None:
            self.capture.calls.append((_clone(E), None, _clone(G)))
        return G

    def _draws(self, state, inv_mass, generator) -> dict:
        """The step's random numbers, drawn as the kernel draws them when left
        to itself, as its keyword arguments."""
        from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched
        from dropout_hamiltonian_montecarlo_tpu_torch.ops import metrics, streams, tree

        if self.sampler == "nuts":
            z0, unravel = tree.tree_batch_ravel(state.position)
            draws = nuts_batched.sample_draws(z0.shape[0], z0.shape[1],
                                              int(self.ctx.traffic["max_tree_depth"]),
                                              generator, z0.device, z0.dtype)
            kept = {"momentum": _clone(unravel(draws.momentum)), "direction": draws.direction,
                    "leaf_uniform": draws.leaf_uniform, "bias_uniform": draws.bias_uniform}
            return {"draws": draws}, kept
        momentum = metrics.diagonal_metric(inv_mass).sample_momentum(state.position, generator)
        uniforms = streams.rand(state.logdensity.shape, generator=generator,
                                dtype=state.logdensity.dtype, device=state.logdensity.device)
        return ({"momentum": momentum, "uniforms": uniforms},
                {"momentum": _clone(momentum), "uniforms": uniforms})

    def step(self, state, step_sizes, inv_mass, *, generator):
        i = self.draw_index
        self.draw_index += 1
        given = {}
        if self.capturing and (i in self.ctx.capture_at or i == self.chunk_first):
            given, kept = self._draws(state, inv_mass, generator)
            self.capture = SimpleNamespace(index=i, pre=_state(state), calls=[], draws=kept)
        new, info = self.kernel(state, step_sizes, inv_mass, generator=generator, **given)
        if self.capture is not None:
            self.capture.post_kernel = _state(new)
            self.capture.accept_prob = info.acceptance_prob.clone()
            self.capture.accepted = info.is_accepted.clone()
        return new, info

    def gibbs(self, state, *, generator):
        from dropout_hamiltonian_montecarlo_tpu_torch.ops import streams

        cap = self.capture
        given = {}
        if cap is not None:
            # the move's own draws: (C, D) normals for the weights, then (C,)
            c, d = state.position["weights"].shape[:2]
            dev = state.logdensity.device
            given = {"eps_w": streams.randn((c, d), generator=generator, device=dev),
                     "eps_b": streams.randn((c,), generator=generator, device=dev)}
        with self.ctx.spans("perfbench.gibbs"):
            new = self.gibbs_fn(state, generator=generator, **given)
        if cap is not None:
            cap.gibbs_eps = torch.cat([given["eps_w"], given["eps_b"][:, None]], dim=1)
            cap.post_gibbs = _state(new)
            if cap.index in self.ctx.capture_at:
                self.captures.append(cap)
            else:
                self.last_chunk_capture = cap
            self.capture = None
        return new

    # ---- the window ----------------------------------------------------------

    def _run(self, n: int):
        from dropout_hamiltonian_montecarlo_tpu_torch.parallel import chains, mesh

        self.state, positions, _ = chains.sample_batched_sharded(
            self.step, self.state, self.step_size, self.inv_mass, n, mesh.RankLayout(1),
            generator=self.gen, post_step=self.gibbs)
        return positions

    def _new_slab(self):
        w = self.qmap["weights"]
        self.slabs.append([w.new_empty((self.chains, self.slab_draws) + tuple(w.shape)),
                           w.new_empty((self.chains, self.slab_draws, w.shape[-1])), 0])

    def chunk(self) -> int:
        self.chunk_first = self.draw_index
        pos = self._run(self.chunk_draws)
        finite = (torch.isfinite(pos["weights"]).flatten(2).all(2)
                  & torch.isfinite(pos["bias"]).all(2))
        self.bad += (~finite).sum() + (~torch.isfinite(self.state.logdensity)).sum()
        n = self.chunk_draws
        if self.slabs[-1][2] + n > self.slab_draws:
            self._new_slab()
        slab = self.slabs[-1]
        slab[0][:, slab[2]:slab[2] + n] = pos["weights"]
        slab[1][:, slab[2]:slab[2] + n] = pos["bias"]
        slab[2] += n
        return self.chains * n

    def work_flop(self) -> float:
        return self.calls * self.flop_per_call

    def close(self) -> dict:
        """The window's draws back in parameter space and their ESS over every
        coordinate; frees the draws."""
        w = torch.cat([slab[0][:, :slab[2]] for slab in self.slabs], dim=1)
        b = torch.cat([slab[1][:, :slab[2]] for slab in self.slabs], dim=1)
        self.slabs = []
        for i in range(self.chains):
            dq = self.metric.unwhiten({"weights": w[i], "bias": b[i]})
            w[i] = self.qmap["weights"] + dq["weights"]
            b[i] = self.qmap["bias"] + dq["bias"]
        ess = torch.cat([ess_mod.effective_sample_size(w, block_size=512).reshape(-1),
                         ess_mod.effective_sample_size(b).reshape(-1)]).cpu().numpy()
        draws = int(w.shape[1])
        del w, b
        counters = {}
        if self.sampler == "nuts":
            counters["leaves"] = self.kernel.leaves_executed - self.leaves0
        return {"chains": self.chains, "draws_per_chain": draws, "ess": ess,
                "failed": int(self.bad), "timings": self.timings, "counters": counters,
                "vag_bound_s": self.vag_bound_s}

    def check(self, reference) -> dict:
        caps = list(self.captures)
        if self.last_chunk_capture is not None:
            caps.append(self.last_chunk_capture)
        basis = {"U_g": self.metric.U_g, "U_a": self.metric.U_a,
                 "d_aug": self.metric.d_aug, "qmap": self.qmap}
        return reference.check_whitened(
            self.X, self.Y, self.alpha, int(self.ctx.config["newton_steps"]), self.init_seed,
            basis, caps, self.step_size, sampler=self.sampler,
            tree_depth=int(self.ctx.traffic.get("max_tree_depth", 0)))
