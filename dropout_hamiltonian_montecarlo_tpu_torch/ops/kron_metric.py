"""Exact Kronecker-factored Gauss-Newton metric for the softmax posterior.

With the bias treated as the weight of a constant feature, the Gauss-Newton
Hessian plus the isotropic prior is

    M = (U_g (x) U_a) diag(s_g (x) s_a + alpha) (U_g (x) U_a)^T

where G = [X, 1]^T [X, 1] = U_g diag(s_g) U_g^T (augmented Gram, (D+1)^2)
and A = U_a diag(s_a) U_a^T is the class Fisher (K x K).  HMC runs in the
whitened coordinates e = M^{1/2} (q - q_map), where the posterior is close to
N(0, I).  The eigendecompositions run in float64 on the host; the Gram GEMM
and every map below run on the tensors' device in float32.

Setups are stored as npz files with the JAX package's keys (s_g, U_g, s_a,
U_a, qw, qb), so one setup can be loaded by both packages.
"""

from __future__ import annotations

import functools
import hashlib
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import softmax_glm, streams
from .metrics import Metric
from .softmax_glm import split_bf16_input
from .tree import Params, tree_add, tree_randn_like


def gram_eigh(X: torch.Tensor):
    """Eigendecomposition of the Gram matrix X^T X.  The GEMM runs on X's
    device in f32; only the (D, D) result goes to the host.  Returns host
    float64 (s_f (D,), U_f (D, D))."""
    s_f, U_f = np.linalg.eigh((X.T @ X).double().cpu().numpy())
    return np.maximum(s_f, 0.0), U_f


def gram_eigh_augmented(X: torch.Tensor):
    """Eigendecomposition of [X, 1]^T [X, 1] = [[X^T X, n xbar], [n xbar^T, n]].
    The Gram GEMM runs on X's device in f32; only the (D+1)^2 result goes to
    the host.  Returns host float64 (s_g (D+1,), U_g (D+1, D+1))."""
    n = X.shape[0]
    F = (X.T @ X).double().cpu().numpy()
    xbar_n = X.sum(dim=0).double().cpu().numpy()
    G = np.block([[F, xbar_n[:, None]], [xbar_n[None, :], np.array([[float(n)]])]])
    s_g, U_g = np.linalg.eigh(G)
    return np.maximum(s_g, 0.0), U_g


def class_fisher_eigh(n_classes: int, probs: Optional[torch.Tensor] = None):
    """Eigendecomposition of the class Fisher: the uniform categorical's
    I/K - 11^T/K^2, or the mean empirical Fisher of ``probs`` (n, K)."""
    k = n_classes
    if probs is None:
        A = np.eye(k) / k - np.ones((k, k)) / (k * k)
    else:
        A_dev = torch.diag(probs.mean(dim=0)) - (probs.T @ probs) / probs.shape[0]
        A = A_dev.double().cpu().numpy()
    s_a, U_a = np.linalg.eigh(A)
    return np.maximum(s_a, 0.0), U_a


class KronMetric:
    """The augmented Kronecker Gauss-Newton metric over {'weights': (..., D, K),
    'bias': (..., K)} dicts; every map accepts any leading batch (chain) axes."""

    def __init__(self, gram, fisher, alpha: float, device):
        # the host float64 inputs: a metric rebuilt from them is this one, bit
        # for bit (shared_gn_setup sends them to the other ranks)
        self.gram, self.fisher = gram, fisher
        s_g, U_g = gram
        s_a, U_a = fisher
        f32 = dict(dtype=torch.float32, device=device)
        self.U_g = torch.as_tensor(np.asarray(U_g), **f32)          # (D+1, D+1)
        self.U_a = torch.as_tensor(np.asarray(U_a), **f32)          # (K, K)
        d_aug = np.outer(s_g, s_a) + alpha                         # float64
        self.d_aug = torch.as_tensor(d_aug, **f32)                 # (D+1, K)
        self.sqrt_d = torch.sqrt(self.d_aug)
        self.alpha = float(alpha)
        self.aux = {"s_f": np.asarray(s_g)[:-1], "s_g": np.asarray(s_g),
                    "s_a": np.asarray(s_a),
                    "d_w": self.d_aug[:-1].cpu().numpy(),
                    "d_b": self.d_aug[-1].cpu().numpy(),
                    "alpha": float(alpha), "augmented": True}

    @staticmethod
    def pack(p: Params) -> torch.Tensor:
        return torch.cat([p["weights"], p["bias"].unsqueeze(-2)], dim=-2)

    @staticmethod
    def unpack(wa: torch.Tensor) -> Params:
        return {"weights": wa[..., :-1, :], "bias": wa[..., -1, :]}

    def to_eigen(self, p: Params) -> torch.Tensor:
        return self.U_g.T @ self.pack(p) @ self.U_a

    def from_eigen(self, e: torch.Tensor) -> Params:
        return self.unpack(self.U_g @ e @ self.U_a.T)

    def sample_momentum(self, position: Params, generator: torch.Generator) -> Params:
        """p ~ N(0, M), one draw per leading (chain) index of ``position``."""
        lead = tuple(position["bias"].shape[:-1])
        eps = streams.randn(lead + tuple(self.d_aug.shape), generator=generator,
                            device=self.d_aug.device, chain_axis=0 if lead else None)
        return self.from_eigen(self.sqrt_d * eps)

    def kinetic_energy(self, momentum: Params) -> torch.Tensor:
        e = self.to_eigen(momentum)
        return 0.5 * (e * e / self.d_aug).sum(dim=(-2, -1))

    def kinetic_grad(self, momentum: Params) -> Params:
        return self.from_eigen(self.to_eigen(momentum) / self.d_aug)

    def sample_position(self, mean: Params, eps: torch.Tensor) -> Params:
        """q ~ N(mean, M^-1) given standard-normal ``eps`` of shape (..., D+1, K)."""
        return tree_add(mean, self.from_eigen(eps / self.sqrt_d))

    def whiten(self, dq: Params) -> Params:
        """e = M^{1/2} dq."""
        return self.unpack(self.sqrt_d * self.to_eigen(dq))

    def unwhiten(self, e: Params) -> Params:
        """dq = M^{-1/2} e."""
        return self.from_eigen(self.pack(e) / self.sqrt_d)

    def whiten_transpose(self, g_e: Params) -> Params:
        """The transpose of the linear map ``whiten``: carries a gradient in
        whitened space back to parameter space,
        g = unpack(U_g (sqrt_d * pack(g_e)) U_a^T)."""
        return self.from_eigen(self.sqrt_d * self.pack(g_e))

    def unwhiten_transpose(self, g: Params) -> Params:
        """The transpose of the linear map ``unwhiten``: carries a gradient
        in parameter space to whitened space,
        g_e = unpack((U_g^T pack(g) U_a) / sqrt_d)."""
        return self.unpack(self.unwhiten_transpose_packed(g))

    def unwhiten_transpose_packed(self, g: Params) -> torch.Tensor:
        """``unwhiten_transpose`` before the unpack: one (..., D+1, K)."""
        return self.to_eigen(g) / self.sqrt_d


def softmax_gauss_newton_metric(X: torch.Tensor, n_classes: int, alpha: float,
                                likelihood_scale: float = 1.0,
                                probs: Optional[torch.Tensor] = None, gram=None,
                                return_aux: bool = False, augmented: bool = False,
                                fisher=None):
    """Metric for params {'weights': (..., D, K), 'bias': (..., K)}; every map
    accepts any leading (chain) axes and ``kinetic_energy`` sums over the last
    two (one) axes only.

    ``likelihood_scale`` rescales the data term (data_size / batch_size for a
    scaled minibatch density).  ``probs``: (n, K) predicted class
    probabilities, e.g. at the MAP: the class factor becomes the mean
    empirical Fisher instead of the uniform categorical's.  ``gram``: a
    precomputed ``gram_eigh(X)`` (``gram_eigh_augmented(X)`` with
    ``augmented``), so a two-stage build pays for the eigendecomposition
    once.  ``fisher``: a precomputed (s_a, U_a), which takes precedence over
    ``probs``.  ``return_aux``: also return the spectral pieces {s_f, s_a,
    d_w, d_b, alpha}, which ``make_whitened_gauge_gibbs`` reads.

    ``augmented=False``: separate weight and bias blocks, M_W = (U_f (x) U_a)
    diag(c s_f (x) s_a + alpha) (U_f (x) U_a)^T and M_b = U_a diag(c n s_a +
    alpha) U_a^T.  ``sample_position(mean, eps)`` takes a standard-normal
    dict ``eps`` shaped like ``mean``.  ``augmented=True``: the bias as the
    weight of a constant feature, the exact Gauss-Newton-plus-prior metric: a
    ``KronMetric`` (whose ``sample_position`` takes eps of shape (..., D+1, K))."""
    k = n_classes
    c = float(likelihood_scale)
    s_a, U_a = fisher if fisher is not None else class_fisher_eigh(k, probs)
    if augmented:
        metric = KronMetric(gram if gram is not None else gram_eigh_augmented(X),
                            (c * np.asarray(s_a), U_a), alpha, X.device)
        aux = dict(metric.aux, s_a=np.asarray(s_a))
        return (metric, aux) if return_aux else metric

    n = X.shape[0]
    s_f, U_f = gram if gram is not None else gram_eigh(X)
    f32 = dict(dtype=torch.float32, device=X.device)
    U_f = torch.as_tensor(np.asarray(U_f), **f32)
    U_a = torch.as_tensor(np.asarray(U_a), **f32)
    d_w = torch.as_tensor(c * np.outer(s_f, s_a) + alpha, **f32)      # (D, K)
    d_b = torch.as_tensor(c * n * np.asarray(s_a) + alpha, **f32)     # (K,)
    sqrt_w, sqrt_b = torch.sqrt(d_w), torch.sqrt(d_b)

    def to_eigen(p: Params) -> Params:
        return {"weights": U_f.T @ p["weights"] @ U_a, "bias": p["bias"] @ U_a}

    def from_eigen(e: Params) -> Params:
        return {"weights": U_f @ e["weights"] @ U_a.T, "bias": e["bias"] @ U_a.T}

    def sample_momentum(position: Params, generator: torch.Generator) -> Params:
        eps = tree_randn_like(position, generator)
        return from_eigen({"weights": sqrt_w * eps["weights"], "bias": sqrt_b * eps["bias"]})

    def kinetic_energy(momentum: Params) -> torch.Tensor:
        e = to_eigen(momentum)
        return 0.5 * ((e["weights"] ** 2 / d_w).sum(dim=(-2, -1))
                      + (e["bias"] ** 2 / d_b).sum(dim=-1))

    def kinetic_grad(momentum: Params) -> Params:
        e = to_eigen(momentum)
        return from_eigen({"weights": e["weights"] / d_w, "bias": e["bias"] / d_b})

    def sample_position(mean: Params, eps: Params) -> Params:
        return tree_add(mean, from_eigen({"weights": eps["weights"] / sqrt_w,
                                          "bias": eps["bias"] / sqrt_b}))

    def whiten(dq: Params) -> Params:
        e = to_eigen(dq)
        return {"weights": sqrt_w * e["weights"], "bias": sqrt_b * e["bias"]}

    def unwhiten(e: Params) -> Params:
        return from_eigen({"weights": e["weights"] / sqrt_w, "bias": e["bias"] / sqrt_b})

    metric = Metric(sample_momentum, kinetic_energy, kinetic_grad, sample_position,
                    whiten, unwhiten)
    if return_aux:
        return metric, {"s_f": np.asarray(s_f), "s_a": np.asarray(s_a),
                        "d_w": d_w.cpu().numpy(), "d_b": d_b.cpu().numpy(),
                        "alpha": float(alpha)}
    return metric


def natural_gradient_map(grad_fn, metric: KronMetric, init_params: Params,
                         num_steps: int = 50, learning_rate: float = 1.0) -> Params:
    """MAP by natural-gradient ascent q += lr * M^-1 grad: Newton's method
    for the GLM when M is the Gauss-Newton Hessian."""
    q = init_params
    for _ in range(num_steps):
        nat = metric.kinetic_grad(grad_fn(q))
        q = {k: q[k] + learning_rate * nat[k] for k in q}
    return q


def logistic_gauss_newton_metric(X: torch.Tensor, alpha: float,
                                 likelihood_scale: float = 1.0) -> Metric:
    """The Gauss-Newton metric for logistic regression params {'weights':
    (C, D), 'bias': (C,)}: H ~ 0.25 X^T X + alpha I (0.25 is the largest
    Bernoulli variance).  The eigendecomposition runs in float64 on the host."""
    Xn = X.detach().double().cpu().numpy()
    n = Xn.shape[0]
    s_f, U_f = np.linalg.eigh(0.25 * (Xn.T @ Xn))
    s_f = np.maximum(s_f, 0.0)
    f32 = dict(dtype=torch.float32, device=X.device)
    U_f = torch.as_tensor(U_f, **f32)
    d_w = torch.as_tensor(likelihood_scale * s_f + alpha, **f32)
    d_b = float(np.float32(likelihood_scale * 0.25 * n + alpha))

    def sample_momentum(position: Params, generator: torch.Generator) -> Params:
        eps = tree_randn_like(position, generator)
        return {"weights": (torch.sqrt(d_w) * eps["weights"]) @ U_f.T,
                "bias": math.sqrt(d_b) * eps["bias"]}

    def kinetic_energy(momentum: Params) -> torch.Tensor:
        e = momentum["weights"] @ U_f
        return 0.5 * ((e * e / d_w).sum(dim=-1) + momentum["bias"] ** 2 / d_b)

    def kinetic_grad(momentum: Params) -> Params:
        e = momentum["weights"] @ U_f
        return {"weights": (e / d_w) @ U_f.T, "bias": momentum["bias"] / d_b}

    return Metric(sample_momentum, kinetic_energy, kinetic_grad)


def _setup_path(cache_dir, X, y_onehot, alpha, newton_steps, provenance, seed):
    k = y_onehot.shape[1]
    cls = torch.arange(k, dtype=torch.float64, device=y_onehot.device)
    fp = (provenance, tuple(int(s) for s in X.shape),
          tuple(int(s) for s in y_onehot.shape),
          float(X.sum(dtype=torch.float64)),
          float((X.double() ** 2).sum()),
          float((y_onehot.double() * cls).sum()),
          float(alpha), int(newton_steps), int(seed))
    h = hashlib.sha256(repr(fp).encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"kron_setup_torch_{h}.npz")


def save_gn_setup(path: str, gram, fisher, qmap: Params) -> None:
    """Write a setup npz atomically (temporary file, then os.replace)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, s_g=gram[0], U_g=gram[1], s_a=fisher[0], U_a=fisher[1],
                 qw=qmap["weights"].cpu().numpy(), qb=qmap["bias"].cpu().numpy())
    os.replace(tmp, path)


def cached_gn_setup(X: torch.Tensor, y_onehot: torch.Tensor, model, alpha: float,
                    newton_steps: int = 60, cache_dir: Optional[str] = None,
                    provenance: str = "", n_classes: int = 10, seed: int = 0):
    """Metric setup for the softmax posterior: augmented Gram eigh ->
    uniform-Fisher Newton MAP -> class Fisher at the MAP -> final metric.

    Cached as an npz under ``cache_dir`` (None: no cache), keyed by a hash of
    the dataset's shape and moments and the settings.  Returns
    (metric, aux, qmap, from_cache); ``aux['timings']`` holds the seconds of
    each stage (on a CUDA device each stage ends in a synchronize).
    """
    device = X.device
    timings = {}

    def mark(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = time.perf_counter() - t0

    path = None
    if cache_dir:
        path = _setup_path(cache_dir, X, y_onehot, alpha, newton_steps,
                           provenance, seed)
    if path is not None and os.path.exists(path):
        t0 = time.perf_counter()
        metric, _, qmap = load_gn_setup(path, alpha, device)
        mark("load", t0)
        aux = dict(metric.aux, timings=timings)
        return metric, aux, qmap, True

    t0 = time.perf_counter()
    gram = gram_eigh_augmented(X)
    mark("gram_eigh", t0)

    t0 = time.perf_counter()
    metric0 = KronMetric(gram, class_fisher_eigh(n_classes), alpha, device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    q0 = model.init_params(gen, device)
    qmap = natural_gradient_map(lambda q: model.analytic_grad(q, (X, y_onehot)),
                                metric0, q0, num_steps=newton_steps)
    mark("newton_map", t0)

    t0 = time.perf_counter()
    fisher = class_fisher_eigh(n_classes, model.predict(qmap, X, prob=True))
    metric = KronMetric(gram, fisher, alpha, device)
    mark("class_fisher", t0)

    if path is not None:
        save_gn_setup(path, gram, fisher, qmap)
    aux = dict(metric.aux, timings=timings)
    return metric, aux, qmap, False


def shared_gn_setup(X: torch.Tensor, y_onehot: torch.Tensor, model, alpha: float,
                    layout=None, **kwargs):
    """``cached_gn_setup`` for every rank of a sharded run: rank 0 computes it
    and sends the host float64 pieces (Gram and class-Fisher eigenpairs) and
    the MAP to the others, which rebuild the metric from them.  So every
    rank samples under the same metric, bit for bit, whatever its own
    eigensolver would have returned.  Without a joined group (``layout`` None
    or without process groups) it is ``cached_gn_setup``."""
    if layout is None or not layout.distributed:
        return cached_gn_setup(X, y_onehot, model, alpha, **kwargs)
    from ..parallel.mesh import broadcast_object

    mine = None
    if layout.rank == 0:
        mine = cached_gn_setup(X, y_onehot, model, alpha, **kwargs)
        metric, aux, qmap, cached = mine
        payload = (metric.gram, metric.fisher,
                   {k: v.cpu().numpy() for k, v in qmap.items()}, aux["timings"], cached)
    else:
        payload = None
    gram, fisher, qmap_np, timings, cached = broadcast_object(payload)
    if mine is not None:
        return mine
    metric = KronMetric(gram, fisher, alpha, X.device)
    qmap = {k: torch.as_tensor(v, device=X.device) for k, v in qmap_np.items()}
    return metric, dict(metric.aux, timings=timings), qmap, cached


def load_gn_setup(npz_path: str, alpha: float, device):
    """(metric, aux, qmap) from a setup npz written by either package
    (keys s_g, U_g, s_a, U_a, qw, qb)."""
    with np.load(npz_path) as z:
        gram = (z["s_g"], z["U_g"])
        fisher = (z["s_a"], z["U_a"])
        qmap = {"weights": torch.as_tensor(z["qw"], dtype=torch.float32, device=device),
                "bias": torch.as_tensor(z["qb"], dtype=torch.float32, device=device)}
    metric = KronMetric(gram, fisher, alpha, device)
    return metric, metric.aux, qmap


def make_whitened_gauge_gibbs(metric: KronMetric, aux, qmap: Params):
    """Exact Gibbs move on the softmax gauge subspace, in whitened coordinates.

    The likelihood is invariant under uniform logit shifts, so the whitened
    coordinates on the class-Fisher null column j0 = argmin s_a are pure
    prior, Gaussian and independent of the rest:
        e_(i, j0) ~ N(-whiten(qmap)_(i, j0), d_w(i, j0) / alpha).
    Resampling them after every draw is exact; the state's log density and
    gradient are updated in closed form (no pass over the data).

    Returns ``gibbs(state, *, eps_w=None, eps_b=None, generator=None)`` for a
    chain-batched whitened HMCState; eps_w (C, D) and eps_b (C,) are the
    standard-normal draws, injected or taken from ``generator``.
    """
    s_a = np.asarray(aux["s_a"])
    j0 = int(np.argmin(s_a))
    alpha = float(aux["alpha"])
    device = metric.d_aug.device
    d_col = torch.as_tensor(np.asarray(aux["d_w"])[:, j0], dtype=torch.float32,
                            device=device)
    sig_w = torch.sqrt(d_col / alpha)                             # (D,)
    d_b0 = float(np.asarray(aux["d_b"])[j0])
    sig_b = float(np.float32(math.sqrt(d_b0 / alpha)))

    wq = metric.whiten(qmap)
    m_w = -wq["weights"][:, j0]                                   # (D,)
    m_b = -wq["bias"][j0]                                         # ()

    def gibbs(state, *, eps_w: Optional[torch.Tensor] = None,
              eps_b: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        e = state.position
        g = state.logdensity_grad
        c = e["bias"].shape[0]
        if eps_w is None or eps_b is None:
            if generator is None:
                raise ValueError("pass eps_w=/eps_b= or an explicit generator=")
            eps_w = streams.randn((c, m_w.shape[0]), generator=generator, device=device)
            eps_b = streams.randn((c,), generator=generator, device=device)
        old_w = e["weights"][:, :, j0]                            # (C, D)
        old_b = e["bias"][:, j0]                                  # (C,)
        zold_w = (old_w - m_w[None]) / sig_w[None]
        zold_b = (old_b - m_b) / sig_b
        new_w = m_w[None] + sig_w[None] * eps_w
        new_b = m_b + sig_b * eps_b
        # log N(e; m, sig^2) difference, dropping the shared normaliser
        delta = -0.5 * ((eps_w ** 2 - zold_w ** 2).sum(dim=-1)
                        + eps_b ** 2 - zold_b ** 2)
        pos_w = e["weights"].clone()
        pos_w[:, :, j0] = new_w
        pos_b = e["bias"].clone()
        pos_b[:, j0] = new_b
        # d logp / d e = -(e - m) / sig^2 on the gauge coordinates
        grad_w = g["weights"].clone()
        grad_w[:, :, j0] = -eps_w / sig_w[None]
        grad_b = g["bias"].clone()
        grad_b[:, j0] = -eps_b / sig_b
        return state._replace(position={"weights": pos_w, "bias": pos_b},
                              logdensity=state.logdensity + delta,
                              logdensity_grad={"weights": grad_w, "bias": grad_b})

    return gibbs


def graph_key(E: Params) -> Tuple:
    """What a CUDA graph of the whitened call depends on in its input E: each
    leaf's name, shape, dtype and device.  A call whose key is the held
    graph's replays it; a call with any other key captures anew."""
    return tuple((k, tuple(E[k].shape), E[k].dtype, E[k].device) for k in sorted(E))


# Captures of the whitened call's CUDA graphs (``_WhitenedGraph``), one a
# variant and input key; a replay counts as a kernel launch of its variant in
# ``softmax_glm.launch_counts`` instead.
graph_counts = {"captures": 0}

# The whitened call's three stages, each under its span: the map into
# parameter space, the fused (or plain) call, the map back.
VAG_SPANS = ("vag.unwhiten", "vag.kernel", "vag.unwhiten_t")


def _run_stages(stages, x):
    for name, stage in zip(VAG_SPANS, stages):
        with profiling.span(name):
            x = stage(x)
    return x


class _WhitenedGraph:
    """One variant of the whitened call, its three stages captured as three
    CUDA graphs and replayed under their spans (``VAG_SPANS``), so the
    kernels of each are read as in the eager call.

    ``stages`` map the whitened position E through Q to (value or None, the
    packed (C, D+1, K) whitened gradient).  A call whose ``graph_key``
    differs from the held graphs' drops them (one set a variant), runs the
    stages once on a side stream (the first call also loads the library and
    sizes the kernel's grids), and captures each.  Every call copies E into
    the static input, replays the three graphs on the current stream, and
    returns clones of the outputs: a state or a checkpoint that keeps a
    gradient must not see the next replay overwrite it.  A capture that
    fails raises.  Each replay counts as one kernel launch of its variant in
    ``softmax_glm.launch_counts`` (and its forward items in
    ``forward_items_overlapped``); the warm-up and the capture count none."""

    def __init__(self, stages, variant: str):
        self.stages, self.variant = stages, variant
        self.key = self.graphs = self.inp = self.outs = None
        self.overlapped = 0

    def _capture(self, E: Params, key: Tuple) -> None:
        self.key = self.graphs = self.inp = self.outs = None
        saved = dict(softmax_glm.launch_counts), softmax_glm.forward_items_overlapped
        try:
            inp = {k: v.clone(memory_format=torch.contiguous_format) for k, v in E.items()}
            device = next(iter(inp.values())).device
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                x = inp
                for stage in self.stages:
                    x = stage(x)
            stream.wait_stream(side)
            before = softmax_glm.forward_items_overlapped
            # each stage's outputs stay held: the next stage's graph reads them
            graphs, outs = [], [inp]
            for stage in self.stages:
                graphs.append(torch.cuda.CUDAGraph())
                with torch.cuda.graph(graphs[-1]):
                    outs.append(stage(outs[-1]))
            overlapped = softmax_glm.forward_items_overlapped - before
        finally:
            softmax_glm.launch_counts.update(saved[0])
            softmax_glm.forward_items_overlapped = saved[1]
        self.key, self.graphs, self.inp, self.outs = key, graphs, inp, outs
        self.overlapped = overlapped
        graph_counts["captures"] += 1

    def __call__(self, E: Params):
        key = graph_key(E)
        if key != self.key:
            self._capture(E, key)
        with profiling.span("vag.graph"):
            for k, v in self.inp.items():
                v.copy_(E[k])
            for name, graph in zip(VAG_SPANS, self.graphs):
                with profiling.span(name):
                    graph.replay()
            value, ge = self.outs[-1]
            value = value.clone() if value is not None else None
            ge = ge.clone()
        softmax_glm.launch_counts[self.variant] += 1
        softmax_glm.forward_items_overlapped += self.overlapped
        return value, ge


def make_whitened_fused_vag(model, metric: KronMetric, qmap: Params, batch,
                            use_kernel: bool = True):
    """Chain-batched value+grad of the whitened log posterior
    e -> logpost(qmap + unwhiten(e)), through the fused softmax-GLM op.

    Returns (batched_vag, batched_grad): ``batched_vag`` gives ((C,) values,
    whitened grads) with the accurate value; ``batched_grad`` is the
    grad-only variant for the inner leapfrog steps (no value).  Both share
    one set of the kernel's bf16 pieces of X, cut here once (CUDA only).
    ``use_kernel=False`` asks for the plain PyTorch version by name.

    On a CUDA X with the kernel, each variant's three stages (the map into
    parameter space, the kernel's launches and the prior, the map back) are
    CUDA graphs, captured at its first call and replayed on every later one
    (``_WhitenedGraph``), so the host enqueues three replays where it
    enqueued some thirty launches; the outputs are bit for bit the eager
    call's.  The CPU route and ``use_kernel=False`` run eagerly."""
    X = batch[0]
    graphed = X.is_cuda and use_kernel
    x_split = split_bf16_input(X) if graphed else None
    fused_q = model.make_fused_value_and_grad(batch, x_split=x_split, use_kernel=use_kernel)
    fused_g = model.make_fused_value_and_grad(batch, fwd_full=False, x_split=x_split,
                                              use_kernel=use_kernel)

    def to_params(E: Params) -> Params:
        dQ = metric.unwhiten(E)
        return {k: qmap[k][None] + dQ[k] for k in qmap}

    def back(value_G):
        value, G = value_G
        return value, metric.unwhiten_transpose_packed(G)

    # each variant: E -> (value or None, the packed (C, D+1, K) whitened grad)
    stages_q = (to_params, fused_q, back)
    stages_g = (to_params, lambda Q: (None, fused_g(Q)), back)
    if graphed:
        call_q = _WhitenedGraph(stages_q, "value_and_grad")
        call_g = _WhitenedGraph(stages_g, "grad")
    else:
        call_q = functools.partial(_run_stages, stages_q)
        call_g = functools.partial(_run_stages, stages_g)

    def batched_vag(E: Params):
        value, ge = call_q(E)
        return value, KronMetric.unpack(ge)

    def batched_grad(E: Params) -> Params:
        return KronMetric.unpack(call_g(E)[1])

    return batched_vag, batched_grad
