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


def _inputs(n, d, k, c, device, seed=0, w_scale=0.3, grid=True):
    """X on the 8-bit grid k/256 (exact in bf16), or normal (off the grid:
    the kernel's X_lo passes run)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if grid:
        X = torch.randint(0, 256, (n, d), generator=g, device=device).float() / 256.0
    else:
        X = torch.randn((n, d), generator=g, device=device)
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
    v, gw, gb = sg.softmax_value_and_grad(X, Y, W, b, ALPHA,
                                          x_split=sg.split_bf16_input(X))
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


# (N, D, K, C, X on the 8-bit grid): ragged rows (N not a multiple of 128),
# ragged D, chain counts that are not a multiple of the chain group, class
# counts from 2 to 16, and X off the grid
CASES = [(1000, 64, 10, 3, True), (257, 33, 10, 17, True), (4096, 784, 10, 32, True),
         (257, 33, 10, 17, False), (257, 33, 2, 5, True), (300, 50, 7, 20, False),
         (257, 33, 16, 17, True), (300, 50, 16, 3, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("fwd_full", [True, False])
@pytest.mark.parametrize("n,d,k,c,grid", CASES)
def test_kernel_matches_plain(cuda, fwd_full, n, d, k, c, grid):
    """The kernel's GEMMs multiply exact bf16 pieces (X, X_lo; 3 pieces of W
    for the value, 2 for grad-only; 2 of R) into f32 accumulators, so it
    differs from the f32 plain version by f32-level rounding: the pieces'
    truncation is ~2^-24 relative for the value and ~2^-17 for grad-only's
    logits and R, and the tensor cores' truncating accumulation adds a drift
    of ~1e-6 relative.  Measured on the card: value within 4e-3 nat at
    N = 4096 (|value| ~ 1e4), gradients within 6e-6 max|g|.  Tolerances:
    value atol 1e-3 nat + rtol 1e-6, grads rtol 1e-4 with atol 1e-5 max|g|,
    ten times tighter than chip_smoke's f32 bound of 1e-4 max|g|."""
    X, Y, W, b = _inputs(n, d, k, c, cuda, grid=grid)
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
@pytest.mark.parametrize("fwd_full", [True, False])
def test_kernel_is_deterministic(cuda, fwd_full):
    """No atomics: two calls on the same inputs are bit-identical."""
    X, Y, W, b = _inputs(1500, 100, 10, 40, cuda, grid=False)
    split = sg.split_bf16_input(X)
    first = sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=fwd_full, x_split=split)
    second = sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=fwd_full, x_split=split)
    torch.cuda.synchronize()
    for a, b2 in zip(first, second):
        assert (a is None and b2 is None) or torch.equal(a, b2)


# (N, D, K, C, X on the 8-bit grid): more forward work items than the
# persistent grid's blocks, several times over with a ragged last round
# (157 row tiles x 3 or 5 chain groups on 132 SMs); the value variant takes
# 8-chain items at K = 9 and 13, grad-only at 13, and with K odd their Z goes
# over in one part
MANY_ITEMS = [(20000, 100, 10, 40, True), (20000, 100, 13, 40, False), (20000, 100, 9, 40, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("fwd_full", [True, False])
@pytest.mark.parametrize("n,d,k,c,grid", MANY_ITEMS)
def test_persistent_forward_walks_many_items(cuda, fwd_full, n, d, k, c, grid):
    """Each persistent block runs several (row tile, chain group) items, the
    epilogue of one under the next one's main loop: the outputs keep
    test_kernel_matches_plain's tolerances, two calls are bit-identical, and
    forward_items_overlapped counts items - blocks a launch."""
    X, Y, W, b = _inputs(n, d, k, c, cuda, grid=grid)
    split = sg.split_bf16_input(X)
    call = sg.KernelCall(split, Y, W, b, with_value=fwd_full)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    group = 8 if k >= (8 if fwd_full else 12) else 16
    assert call.n_items == -(-n // 128) * -(-c // group)
    assert call.grid == min(call.n_items, sms) and call.n_items > 3 * call.grid
    sg.reset_launch_counts()
    first = sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=fwd_full, x_split=split)
    second = sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=fwd_full, x_split=split)
    torch.cuda.synchronize()
    assert sg.forward_items_overlapped == 2 * (call.n_items - call.grid)
    for a, b2 in zip(first, second):
        assert (a is None and b2 is None) or torch.equal(a, b2)
    v, gw, gb = first
    ll, gw_p, gb_p = sg.softmax_value_and_grad_plain(X, Y, W, b)
    if fwd_full:
        torch.testing.assert_close(v, ll + sg.log_prior_batched(W, b, ALPHA), rtol=1e-6, atol=1e-3)
    for got, ref in ((gw, gw_p - ALPHA * W), (gb, gb_p - ALPHA * b)):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.gpu
def test_small_shapes_overlap_no_forward_items(cuda):
    """Fewer items than blocks: one item a block, nothing to overlap."""
    X, Y, W, b = _inputs(257, 33, 10, 17, cuda)
    sg.reset_launch_counts()
    sg.softmax_value_and_grad(X, Y, W, b, ALPHA)
    sg.softmax_value_and_grad(X, Y, W, b, ALPHA, fwd_full=False)
    torch.cuda.synchronize()
    assert sg.forward_items_overlapped == 0


@pytest.mark.gpu
def test_kernel_raises_on_unsupported_classes(cuda):
    X, Y, W, b = _inputs(100, 8, 17, 2, cuda)
    with pytest.raises(NotImplementedError):
        sg.softmax_value_and_grad(X, Y, W, b, ALPHA)
