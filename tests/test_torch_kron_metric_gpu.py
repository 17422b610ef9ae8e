"""The whitened value+grad as a replayed CUDA graph against the same call
run eagerly, on the card.

This file imports no jax: the machine with the card has none.  Run it there
with

    python -m pytest --noconftest -m gpu tests/test_torch_kron_metric_gpu.py

On a CUDA X with the kernel, ``make_whitened_fused_vag`` captures each
variant's three stages once, as three graphs, and replays them.  The eager reference here is the
same composition run op by op (``metric.unwhiten``, the fused call,
``metric.unwhiten_transpose``): the replayed outputs must equal it bit for
bit, never alias one another across calls, and be counted as launches.
"""

import numpy as np
import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch import full_f32_precision
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric as tkm
from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg
from dropout_hamiltonian_montecarlo_tpu_torch.utils import profiling

ALPHA = 1.0
CALLS = 5
# (N, D, K, C): the bench shape, and a small ragged one
SHAPES = [(60000, 784, 10, 128), (1000, 64, 10, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    full_f32_precision()
    return torch.device("cuda")


def _problem(n, d, k, device, seed=0):
    """X on the 8-bit grid, one-hot labels, a Kronecker metric from random
    orthogonal eigenbases, and a MAP near zero: any metric is a fair test of
    the replay, which must repeat the eager call whatever it computes."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randint(0, 256, (n, d), generator=g, device=device).float() / 256.0
    Y = torch.nn.functional.one_hot(torch.randint(0, k, (n,), generator=g, device=device),
                                    k).float()
    rng = np.random.RandomState(seed)
    U_g = np.linalg.qr(rng.randn(d + 1, d + 1))[0]
    U_a = np.linalg.qr(rng.randn(k, k))[0]
    metric = tkm.KronMetric((rng.uniform(1.0, 100.0, d + 1), U_g),
                            (rng.uniform(0.01, 0.2, k), U_a), ALPHA, device)
    qmap = {"weights": 0.05 * torch.randn((d, k), generator=g, device=device),
            "bias": 0.05 * torch.randn((k,), generator=g, device=device)}
    model = Softmax(dim=d, n_classes=k, alpha=ALPHA)
    return model, metric, qmap, (X, Y)


def _eager(model, metric, qmap, batch):
    """The whitened call, op by op, with the kernel and no graph."""
    split = sg.split_bf16_input(batch[0])
    fused_q = model.make_fused_value_and_grad(batch, x_split=split)
    fused_g = model.make_fused_value_and_grad(batch, fwd_full=False, x_split=split)

    def params(E):
        dQ = metric.unwhiten(E)
        return {k: qmap[k][None] + dQ[k] for k in qmap}

    def vag(E):
        value, G = fused_q(params(E))
        return value, metric.unwhiten_transpose(G)

    def grad(E):
        return metric.unwhiten_transpose(fused_g(params(E)))

    return vag, grad


def _draw(c, d, k, g, device, views=False):
    """E, as two tensors, or with ``views`` as views of one (C, D*K + K)
    tensor, as the NUTS kernel unravels its flat positions."""
    if views:
        flat = 0.5 * torch.randn((c, d * k + k), generator=g, device=device)
        return {"weights": flat[:, :d * k].view(c, d, k), "bias": flat[:, d * k:]}
    return {"weights": 0.5 * torch.randn((c, d, k), generator=g, device=device),
            "bias": 0.5 * torch.randn((c, k), generator=g, device=device)}


def _copy(t):
    return None if t is None else ({k: v.clone() for k, v in t.items()}
                                   if isinstance(t, dict) else t.clone())


def _equal(got, want):
    if want is None:
        return got is None
    if isinstance(want, dict):
        return all(torch.equal(got[k], want[k]) for k in want)
    return torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,c", SHAPES)
def test_replayed_call_equals_eager_bit_for_bit(cuda, n, d, k, c):
    """Both variants over CALLS successive calls with different E, every
    other one given as views of one flat tensor: each output equals the
    eager call's bit for bit, and what call i returned is unchanged after the
    later calls (no output aliases a graph's buffer)."""
    model, metric, qmap, batch = _problem(n, d, k, cuda)
    vag, grad = tkm.make_whitened_fused_vag(model, metric, qmap, batch)
    ref_vag, ref_grad = _eager(model, metric, qmap, batch)
    g = torch.Generator(device=cuda).manual_seed(1)
    kept = []
    for i in range(CALLS):
        E = _draw(c, d, k, g, cuda, views=i % 2 == 1)
        value, G = vag(E)
        G2 = grad(E)
        want_v, want_G = ref_vag(E)
        want_G2 = ref_grad(E)
        assert _equal(value, want_v) and _equal(G, want_G) and _equal(G2, want_G2)
        kept.append(((value, G, G2), _copy(want_v), _copy(want_G), _copy(want_G2)))
    torch.cuda.synchronize()
    for (value, G, G2), want_v, want_G, want_G2 in kept:
        assert _equal(value, want_v) and _equal(G, want_G) and _equal(G2, want_G2)


@pytest.mark.gpu
def test_new_chain_count_recaptures(cuda):
    """A call with another chain count captures that variant anew (one graph
    a variant is held); going back captures again; every output still equals
    the eager call's bit for bit."""
    n, d, k = 1000, 64, 10
    model, metric, qmap, batch = _problem(n, d, k, cuda, seed=3)
    vag, grad = tkm.make_whitened_fused_vag(model, metric, qmap, batch)
    ref_vag, ref_grad = _eager(model, metric, qmap, batch)
    g = torch.Generator(device=cuda).manual_seed(4)
    start, captures = tkm.graph_counts["captures"], []
    replays = {"value_and_grad": 0, "grad": 0}
    for c in (12, 12, 5, 5, 12):
        E = _draw(c, d, k, g, cuda)
        launches = dict(sg.launch_counts)
        value, G = vag(E)
        G2 = grad(E)
        for variant in replays:
            replays[variant] += sg.launch_counts[variant] - launches[variant]
        assert _equal(G, ref_vag(E)[1]) and _equal(value, ref_vag(E)[0])
        assert _equal(G2, ref_grad(E))
        captures.append(tkm.graph_counts["captures"] - start)
    assert captures == [2, 2, 4, 4, 6]
    assert replays == {"value_and_grad": 5, "grad": 5}


@pytest.mark.gpu
def test_counters_equal_the_calls_made(cuda):
    """launch_counts and forward_items_overlapped count one launch a replay,
    as the eager call counts its kernel launch; the warm-up and the capture
    count none; graph_counts holds one capture a variant; the ``vag.graph``
    span opens once a replay, and so do the three stage spans, each around
    its own graph's replay, as they open once an eager call."""
    n, d, k, c = 1000, 64, 10, 12
    model, metric, qmap, batch = _problem(n, d, k, cuda, seed=5)
    vag, grad = tkm.make_whitened_fused_vag(model, metric, qmap, batch)
    ref_vag, ref_grad = _eager(model, metric, qmap, batch)
    g = torch.Generator(device=cuda).manual_seed(6)
    E = _draw(c, d, k, g, cuda)
    n_vag, n_grad = 3, 7

    sg.reset_launch_counts()
    for _ in range(n_vag):
        ref_vag(E)
    for _ in range(n_grad):
        ref_grad(E)
    eager = dict(sg.launch_counts), sg.forward_items_overlapped

    sg.reset_launch_counts()
    captures = tkm.graph_counts["captures"]
    was = profiling.enable(True)
    try:
        before = profiling.totals()
        for _ in range(n_vag):
            vag(E)
        for _ in range(n_grad):
            grad(E)
        after = profiling.totals()
    finally:
        profiling.enable(was)
    assert dict(sg.launch_counts) == eager[0] == {"value_and_grad": n_vag, "grad": n_grad}
    assert sg.forward_items_overlapped == eager[1]
    assert tkm.graph_counts["captures"] - captures == 2
    calls = {name: after[name][0] - before.get(name, (0, 0.0))[0] for name in after}
    for name in ("vag.graph",) + tkm.VAG_SPANS:
        assert calls[name] == n_vag + n_grad, name
