"""One lockstep NUTS step through the CUDA kernel against the same step
through the plain PyTorch version, on the card.

This file imports no jax: the machine with the card has none.  Run it there
with

    python -m pytest --noconftest -m gpu tests/test_torch_nuts_gpu.py

The two steps see the same injected draws (``NUTSDraws``) on the whitened
softmax posterior at N=1000, D=64, K=10, C=16.  The kernel's value and
gradient are f32-level (value within 0.1 nat, gradient within 1e-4 max|g|
at bench shape), so the trees must be the same: equal tree sizes, depths
and flags, positions within 1e-4.
"""

import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch import full_f32_precision
from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric as tkm
from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg

N, D, K, C, ALPHA, DEPTH = 1000, 64, 10, 16, 1.0, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    full_f32_precision()
    return torch.device("cuda")


def _plain_whitened_vag(model, metric, qmap, X, Y):
    """make_whitened_fused_vag's composition around the plain version."""
    def vag(E):
        dq = metric.unwhiten(E)
        W, b = qmap["weights"][None] + dq["weights"], qmap["bias"][None] + dq["bias"]
        ll, gw, gb = sg.softmax_value_and_grad_plain(X, Y, W, b)
        value = ll + sg.log_prior_batched(W, b, model.alpha)
        g = {"weights": gw - model.alpha * W, "bias": gb - model.alpha * b}
        return value, metric.unwhiten_transpose(g)
    return vag


@pytest.mark.gpu
def test_nuts_step_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    X = torch.randint(0, 256, (N, D), generator=g, device=cuda).float() / 256.0
    yi = torch.randint(0, K, (N,), generator=g, device=cuda)
    Y = torch.nn.functional.one_hot(yi, K).float()
    model = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    metric, _, qmap, _ = tkm.cached_gn_setup(X, Y, model, alpha=ALPHA, newton_steps=30)
    kernel_vag, _ = tkm.make_whitened_fused_vag(model, metric, qmap, (X, Y))
    plain_vag = _plain_whitened_vag(model, metric, qmap, X, Y)

    e0 = {"weights": torch.randn((C, D, K), generator=g, device=cuda),
          "bias": torch.randn((C, K), generator=g, device=cuda)}
    eps = torch.linspace(0.15, 0.6, C, device=cuda)
    draws = nuts_batched.sample_draws(C, D * K + K, DEPTH, g, cuda)
    out = {}
    for name, vag in (("kernel", kernel_vag), ("plain", plain_vag)):
        sg.reset_launch_counts()
        kernel = nuts_batched.build_batched_kernel(vag, max_tree_depth=DEPTH)
        new, info = kernel(nuts_batched.batched_init(e0, vag), eps, None, draws=draws)
        torch.cuda.synchronize()
        out[name] = (new, info, dict(sg.launch_counts), kernel.leaves_executed)

    (kn, ki, kc, kl), (pn, pi, pc, pl) = out["kernel"], out["plain"]
    assert kc == {"value_and_grad": 1 + kl, "grad": 0}
    assert pc == {"value_and_grad": 0, "grad": 0}
    assert kl == pl and (ki.num_integration_steps > 1).all()
    for f in ("num_integration_steps", "depth", "is_divergent", "is_accepted"):
        assert torch.equal(getattr(ki, f), getattr(pi, f)), f
    for k in ("weights", "bias"):
        torch.testing.assert_close(kn.position[k], pn.position[k], rtol=0, atol=1e-4)
    torch.testing.assert_close(ki.acceptance_prob, pi.acceptance_prob, rtol=0, atol=1e-3)
