"""The CUDA softmax-GLM kernel against its plain PyTorch version.

This file imports no jax: the machine with the card has none.  Tests marked
``gpu`` need a CUDA device and skip without one (decided inside the test);
run them on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_softmax_glm_gpu.py

(``--noconftest`` because tests/conftest.py configures jax).  The unmarked
tests check the wrapper's routing and input checks, on the CPU.
"""

import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch import full_f32_precision
from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg

ALPHA = 1.0


def _inputs(n, d, k, c, device, seed=0, w_scale=0.3):
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randint(0, 256, (n, d), generator=g, device=device).float() / 256.0
    yi = torch.randint(0, k, (n,), generator=g, device=device)
    Y = torch.nn.functional.one_hot(yi, k).float()
    W = w_scale * torch.randn((c, d, k), generator=g, device=device)
    b = 0.1 * torch.randn((c, k), generator=g, device=device)
    return X, Y, W, b


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    full_f32_precision()
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version():
    X, Y, W, b = _inputs(130, 16, 10, 3, "cpu")
    sg.reset_launch_counts()
    v, gw, gb = sg.softmax_value_and_grad(X, Y, W, b, ALPHA)
    ll, pgw, pgb = sg.softmax_value_and_grad_plain(X, Y, W, b)
    torch.testing.assert_close(v, ll + sg.log_prior_batched(W, b, ALPHA))
    torch.testing.assert_close(gw, pgw - ALPHA * W)
    torch.testing.assert_close(gb, pgb - ALPHA * b)
    assert sg.launch_counts == {"value_and_grad": 0, "grad": 0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    X, Y, W, b = _inputs(64, 8, 10, 2, "cpu")
    if bad == "dtype":
        X = X.double()
    elif bad == "shape":
        b = b[:, :5]
    elif bad == "contiguity":
        X = torch.cat([X, X], dim=1)[:, ::2]
    else:
        Y = Y.to("meta")
    with pytest.raises((TypeError, ValueError)):
        sg.softmax_value_and_grad(X, Y, W, b, ALPHA)


@pytest.mark.gpu
@pytest.mark.parametrize("fwd_full", [True, False])
@pytest.mark.parametrize("n,d,c", [(1000, 64, 3), (257, 33, 17), (4096, 784, 32)])
def test_kernel_matches_plain(cuda, fwd_full, n, d, c):
    """Ragged rows (N not a multiple of 128), ragged D and a chain count that
    is not a multiple of the 16-chain group.  Both sides are f32; the kernel
    sums tiles in a fixed order, so the tolerance is f32 summation noise:
    value atol 1e-3 nat + rtol 1e-6, grads rtol 1e-4 with atol 1e-5 * max|g|."""
    X, Y, W, b = _inputs(n, d, 10, c, cuda)
    ll, gw_p, gb_p = sg.softmax_value_and_grad_plain(X, Y, W, b)
    v, gw, gb = sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=fwd_full)
    torch.cuda.synchronize()
    if fwd_full:
        ref_v = ll + sg.log_prior_batched(W, b, ALPHA)
        torch.testing.assert_close(v, ref_v, rtol=1e-6, atol=1e-3)
    else:
        assert v is None
    for got, ref in ((gw, gw_p - ALPHA * W), (gb, gb_p - ALPHA * b)):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.gpu
def test_kernel_counts_launches_and_likelihood_only(cuda):
    X, Y, W, b = _inputs(600, 40, 10, 5, cuda)
    sg.reset_launch_counts()
    v, gw, gb = sg.softmax_value_and_grad(X, Y, W, b, ALPHA, include_prior=False)
    sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=False)
    sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=False)
    torch.cuda.synchronize()
    assert sg.launch_counts == {"value_and_grad": 1, "grad": 2}
    ll, gw_p, gb_p = sg.softmax_value_and_grad_plain(X, Y, W, b)
    torch.testing.assert_close(v, ll, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(gw, gw_p, rtol=1e-4, atol=1e-5 * float(gw_p.abs().max()))


@pytest.mark.gpu
def test_kernel_raises_on_unsupported_classes(cuda):
    X, Y, W, b = _inputs(100, 8, 7, 2, cuda)
    with pytest.raises(NotImplementedError):
        sg.softmax_value_and_grad(X, Y, W, b, ALPHA)
