"""Parity of the port's fused softmax-GLM value+grad with the JAX package.

On the CPU the port's wrapper runs the plain PyTorch version (the CUDA kernel
is tested on the card in test_torch_softmax_glm_gpu.py).  The same numpy
inputs go through:
  - jax.vmap(jax.value_and_grad(Softmax.make_logdensity)) at 'highest'
    precision: value rtol 1e-6, grads atol 1e-4 * max|g| (both f32, only
    the summation order differs);
  - the Pallas kernel in interpret mode (ops/pallas_glm.py), whose backward
    is single-pass bf16: the tolerances of tests/test_pallas.py (value rtol
    3e-4, grads rtol 2e-2 with atol 3.9e-3 * max|g|).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.pallas_glm import (  # noqa: E402
    softmax_value_and_grad as jax_fused,
)
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg  # noqa: E402

D, K, C = 32, 7, 5
ALPHA = 0.7


def _data(seed, n, grid=True):
    rng = np.random.RandomState(seed)
    if grid:   # the 8-bit grid k/256 of the headline data (exact in bf16)
        X = (rng.randint(0, 256, size=(n, D)) / 256.0).astype(np.float32)
    else:
        X = rng.randn(n, D).astype(np.float32)
    Y = np.eye(K, dtype=np.float32)[rng.randint(0, K, size=n)]
    W = (0.3 * rng.randn(C, D, K)).astype(np.float32)
    b = (0.1 * rng.randn(C, K)).astype(np.float32)
    return X, Y, W, b


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,grid", [(300, False), (257, True)])
def test_plain_matches_jax_autodiff(n, grid):
    X, Y, W, b = _data(0, n, grid)
    ld = JaxSoftmax(dim=D, n_classes=K, alpha=ALPHA).make_logdensity(batch=(X, Y))
    with jax.default_matmul_precision("highest"):
        ref_v, ref_g = jax.vmap(jax.value_and_grad(ld))(
            {"weights": jnp.asarray(W), "bias": jnp.asarray(b)})
    v, gw, gb = sg.softmax_value_and_grad(*_torch(X, Y, W, b), ALPHA)

    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=1e-6)
    for got, ref in ((gw, ref_g["weights"]), (gb, ref_g["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("fwd_full", [True, False])
def test_plain_matches_pallas_interpret(fwd_full):
    """Ragged N (300 rows over 128-row tiles), X on the 8-bit grid."""
    X, Y, W, b = _data(1, 300)
    ref_v, ref_gw, ref_gb = jax_fused(X, Y, W, b, ALPHA, tile_rows=128,
                                      interpret=True, fwd_full=fwd_full)
    tX, tY, tW, tb = _torch(X, Y, W, b)
    ll, _, _ = sg.softmax_value_and_grad_plain(tX, tY, tW, tb)
    v = ll + sg.log_prior_batched(tW, tb, ALPHA)
    value, gw, gb = sg.softmax_value_and_grad(tX, tY, tW, tb, ALPHA,
                                              fwd_full=fwd_full)
    assert (value is None) == (not fwd_full)

    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=3e-4)
    for got, ref in ((gw, ref_gw), (gb, ref_gb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2,
                                   atol=3.9e-3 * np.abs(ref).max())


def test_include_prior_false_row_shards_compose():
    """Likelihood-only outputs of two row shards, summed, plus the prior
    once, equal the full call."""
    tX, tY, tW, tb = _torch(*_data(2, 300, grid=False))
    v_full, gw_full, gb_full = sg.softmax_value_and_grad(tX, tY, tW, tb, ALPHA)
    parts = [sg.softmax_value_and_grad(tX[i:j].contiguous(), tY[i:j].contiguous(),
                                       tW, tb, ALPHA, include_prior=False)
             for i, j in ((0, 150), (150, 300))]
    v = parts[0][0] + parts[1][0] + sg.log_prior_batched(tW, tb, ALPHA)
    gw = parts[0][1] + parts[1][1] - ALPHA * tW
    gb = parts[0][2] + parts[1][2] - ALPHA * tb
    np.testing.assert_allclose(v.numpy(), v_full.numpy(), rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(gw.numpy(), gw_full.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), gb_full.numpy(), rtol=1e-4, atol=1e-4)


def test_model_matches_jax_model():
    """Single-chain log_prior / log_likelihood / predict / analytic_grad and
    the chain-batched fused maker, against the JAX Softmax."""
    X, Y, W, b = _data(3, 200, grid=False)
    jm = JaxSoftmax(dim=D, n_classes=K, alpha=ALPHA)
    tm = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    jp = {"weights": jnp.asarray(W[0]), "bias": jnp.asarray(b[0])}
    tp = {"weights": torch.from_numpy(W[0]), "bias": torch.from_numpy(b[0])}
    tX, tY = _torch(X, Y)
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(float(tm.log_prior(tp)), float(jm.log_prior(jp)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm.log_posterior(tp, (tX, tY))),
                                   float(jm.log_posterior(jp, (X, Y))), rtol=1e-6)
        np.testing.assert_array_equal(tm.predict(tp, tX).numpy(),
                                      np.asarray(jm.predict(jp, X)))
        ref = jm.analytic_grad(jp, (X, Y))
    got = tm.analytic_grad(tp, (tX, tY))
    for key in ("weights", "bias"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r, atol=1e-4 * np.abs(r).max())

    value, grads = tm.make_fused_value_and_grad((tX, tY))(
        {"weights": torch.from_numpy(W), "bias": torch.from_numpy(b)})
    per_chain = [float(tm.log_posterior({"weights": torch.from_numpy(W[c]),
                                         "bias": torch.from_numpy(b[c])}, (tX, tY)))
                 for c in range(C)]
    np.testing.assert_allclose(value.numpy(), per_chain, rtol=1e-6)
    only = tm.make_fused_value_and_grad((tX, tY), fwd_full=False)(
        {"weights": torch.from_numpy(W), "bias": torch.from_numpy(b)})
    np.testing.assert_array_equal(only["weights"].numpy(), grads["weights"].numpy())


# ---- the kernel's bf16 pieces ------------------------------------------------

def _bits(a):
    """uint16 bit patterns of a bf16 torch tensor or a bf16 jax/numpy array."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _x_of_kind(kind, rng, n, d):
    if kind == "normal":
        return rng.randn(n, d).astype(np.float32)
    levels = 256 if kind == "grid256" else 16      # 8-bit MNIST, digits k/16
    return (rng.randint(0, levels, size=(n, d)) / float(levels)).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "grid256", "digits16"])
def test_split_bf16_input_matches_jax(kind):
    """The port's once-per-run X split is bit-identical to
    pallas_glm.split_bf16_input, in both of the kernel's layouts (X and X^T,
    leading dimensions padded to a multiple of 8, X^T with a row of ones for
    grad_b); on both grids lo is None."""
    from dropout_hamiltonian_montecarlo_tpu.ops.pallas_glm import split_bf16_input

    n, d = 257, 33
    X = _x_of_kind(kind, np.random.RandomState(5), n, d)
    ref_hi, ref_lo = split_bf16_input(jnp.asarray(X))
    hi, lo = sg.split_bf16_input(torch.from_numpy(X))
    assert hi.shape == (n, d)
    assert hi.x.shape == (n, 40) and hi.xt.shape == (d + 1, 264)
    np.testing.assert_array_equal(_bits(hi.x[:, :d]), _bits(ref_hi))
    np.testing.assert_array_equal(_bits(hi.xt[:d, :n]), _bits(ref_hi).T)
    assert bool((hi.xt[d, :n] == 1).all())
    if kind == "normal":
        assert lo is not None and ref_lo is not None
        np.testing.assert_array_equal(_bits(lo.x[:, :d]), _bits(ref_lo))
        np.testing.assert_array_equal(_bits(lo.xt[:d, :n]), _bits(ref_lo).T)
        assert bool((lo.xt[d] == 0).all())
    else:
        assert lo is None and ref_lo is None


def test_split_weights_matches_jax():
    """The per-call W split: pieces 0 and 1 are pallas_glm._split_bf16 of the
    folded W (the JAX wrapper's pair), piece 2 the lo half of the same split
    of the remainder; rows are chain-major c*K + k, padded D is zero."""
    from dropout_hamiltonian_montecarlo_tpu.ops.pallas_glm import _split_bf16, fold_chain_params

    _, _, W, b = _data(6, 10, grid=False)
    W2, _ = fold_chain_params(jnp.asarray(W), jnp.asarray(b))      # (D, K*C): k*C + c
    hi, lo = _split_bf16(W2)
    _, lo2 = _split_bf16(W2 - hi.astype(jnp.float32))
    pieces = sg.split_weights(torch.from_numpy(W), 3)
    assert pieces.shape == (3, C * K, 32) and pieces.dtype == torch.bfloat16
    for p, ref in enumerate((hi, lo, lo2)):
        ref_ckd = np.asarray(ref).reshape(D, K, C).transpose(2, 1, 0)   # (C, K, D)
        np.testing.assert_array_equal(_bits(pieces[p].view(C, K, 32)[:, :, :D]),
                                      _bits(ref_ckd))
    assert torch.equal(sg.split_weights(torch.from_numpy(W), 2), pieces[:2])


def _emulated_kernel(X, Y, W, b, n_w, n_r):
    """The kernel's rounding scheme in float64: X (exact in bf16), n_w bf16
    pieces of W and n_r of R, every product exact, Z rounded to f32, the
    softmax in f32, the gradient summed exactly."""
    C_, D_, K_ = W.shape
    N = X.shape[0]
    Wp = sg.split_weights(torch.from_numpy(W), n_w).double()[:, :, :D_]  # (n_w, C*K, D)
    Wsum = Wp.sum(0).numpy()                                             # exact in f64
    Z = (X.astype(np.float64) @ Wsum.T).astype(np.float32).reshape(N, C_, K_) + b
    Zt = torch.from_numpy(Z)
    logp = torch.log_softmax(Zt, dim=-1)
    ll = (torch.from_numpy(Y)[:, None, :].double() * logp.double()).sum(dim=(0, 2))
    R = (torch.from_numpy(Y)[:, None, :] - torch.exp(logp)).reshape(N, C_ * K_)
    Rsum = torch.zeros_like(R, dtype=torch.float64)
    rest = R
    for _ in range(n_r):
        piece = rest.to(torch.bfloat16)
        Rsum += piece.double()
        rest = rest - piece.float()
    gw = (X.astype(np.float64).T @ Rsum.numpy()).reshape(D_, C_, K_).transpose(1, 0, 2)
    return ll.numpy(), gw, Rsum.sum(0).numpy().reshape(C_, K_)


@pytest.mark.parametrize("w_scale", [0.05, 0.3])
def test_kernel_rounding_scheme_meets_the_card_bounds(w_scale):
    """The precision design on the CPU, before the card sees it: at N = 4096,
    D = 784, C = 8, X on the 8-bit grid, the value variant (3 W pieces) and
    the grad-only variant (2) with 2 R pieces meet chip_smoke's bounds
    against float64: value within 0.1 nat, gW and gb within 1e-4 max|g|.
    One W piece (the TPU's grad-only forward) misses the gradient bound, so
    the bound does tell the schemes apart."""
    rng = np.random.RandomState(7)
    n, d, k, c = 4096, 784, 10, 8
    X = (rng.randint(0, 256, size=(n, d)) / 256.0).astype(np.float32)
    Y = np.eye(k, dtype=np.float32)[rng.randint(0, k, size=n)]
    W = (w_scale * rng.randn(c, d, k)).astype(np.float32)
    b = (0.1 * rng.randn(c, k)).astype(np.float32)
    ref_ll, ref_gw, ref_gb = (t.numpy() for t in sg.softmax_value_and_grad_plain(
        *(torch.from_numpy(a).double() for a in (X, Y, W, b))))
    gmax_w, gmax_b = np.abs(ref_gw).max(), np.abs(ref_gb).max()
    for n_w in (3, 2):
        ll, gw, gb = _emulated_kernel(X, Y, W, b, n_w, 2)
        if n_w == 3:
            assert np.abs(ll - ref_ll).max() <= 0.1
        assert np.abs(gw - ref_gw).max() <= 1e-4 * gmax_w
        assert np.abs(gb - ref_gb).max() <= 1e-4 * gmax_b
    _, gw, _ = _emulated_kernel(X, Y, W, b, 1, 2)
    assert np.abs(gw - ref_gw).max() > 1e-4 * gmax_w


def test_backward_slices_bound_the_chain_and_fill_the_device():
    # bench shape on 132 SMs: 7 x 8 output tiles; at least 6 slices keep each
    # at <= 160 of the 938 reduction steps; 7 slices = 2.97 waves, the fewest
    # per slice
    assert sg.backward_slices(60000, 784, 1280, 132) == 7
    # never more slices than reduction steps
    assert sg.backward_slices(100, 33, 30, 132) == 2
    for n, d, ck, slots in ((60000, 784, 1280, 132), (257, 33, 170, 132),
                            (4096, 784, 320, 264), (10 ** 6, 784, 5120, 132)):
        s = sg.backward_slices(n, d, ck, slots)
        steps = -(-n // 64)
        assert -(-steps // s) <= sg.MAX_SLICE_STEPS
        tiles = -(-(d + 1) // 128) * -(-ck // 160)
        waves = lambda q: -(-tiles * q // slots) / q  # noqa: E731
        least = -(-steps // sg.MAX_SLICE_STEPS)
        assert all(waves(s) <= waves(q) for q in range(least, max(least, min(steps, 32)) + 1))


# (N, C, chains per work item, device slots) -> (work items, persistent
# blocks): the bench shape's grad-only (16-chain items) and value (8-chain)
# calls on 132 SMs, the data-parallel shard's 30,000 rows, the ragged GPU
# test shape, and small shapes with fewer items than slots
SCHEDULES = [((60000, 128, 16, 132), (3752, 132)), ((60000, 128, 8, 132), (7504, 132)),
             ((30000, 128, 16, 132), (1880, 132)), ((20000, 40, 16, 132), (471, 132)),
             ((257, 17, 16, 132), (6, 6)), ((1000, 3, 16, 132), (8, 8)),
             ((128 * 132, 16, 16, 132), (132, 132))]


@pytest.mark.parametrize("shape,want", SCHEDULES)
def test_forward_schedule_sizes_the_persistent_grid(shape, want):
    n_items, grid = sg.forward_schedule(*shape)
    assert (n_items, grid) == want
    overlapped = n_items - grid
    assert overlapped >= 0
    if n_items <= shape[3]:
        assert overlapped == 0
    if shape == (60000, 128, 16, 132):   # ~96.5% of the epilogues can hide
        assert overlapped == 3620 and abs(overlapped / n_items - 0.965) < 1e-3


@pytest.mark.parametrize("n_tiles,n_groups,grid", [(469, 8, 132), (469, 16, 132), (157, 3, 132),
                                                   (3, 2, 6), (5, 3, 4), (1, 1, 1)])
def test_forward_walk_covers_every_item_once_with_a_tiles_groups_adjacent(n_tiles, n_groups, grid):
    walk = sg.forward_walk(n_tiles * n_groups, grid, n_groups)
    assert len(walk) == grid and all(walk)
    done = [pair for block in walk for pair in block]
    assert sorted(done) == [(t, g) for t in range(n_tiles) for g in range(n_groups)]
    # the order the blocks run them in: round by round, block by block
    order = [walk[b][r] for r in range(max(map(len, walk))) for b in range(grid) if r < len(walk[b])]
    assert order == [(i // n_groups, i % n_groups) for i in range(n_tiles * n_groups)]
    for t in range(n_tiles):
        at = [k for k, (tile, _) in enumerate(order) if tile == t]
        assert at == list(range(at[0], at[0] + n_groups))
    # a block's load differs from another's by at most one item
    assert max(map(len, walk)) - min(map(len, walk)) <= 1


@pytest.mark.parametrize("slots,group", [(0, 16), (132, 0)])
def test_forward_schedule_rejects_an_empty_grid(slots, group):
    with pytest.raises(ValueError):
        sg.forward_schedule(60000, 128, group, slots)


def test_fused_maker_takes_a_shared_split():
    """make_fused_value_and_grad(x_split=...) gives the same outputs as
    without one; the CPU route ignores the split."""
    tX, tY, tW, tb = _torch(*_data(8, 200))
    tm = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    split = sg.split_bf16_input(tX)
    params = {"weights": tW, "bias": tb}
    v0, g0 = tm.make_fused_value_and_grad((tX, tY))(params)
    v1, g1 = tm.make_fused_value_and_grad((tX, tY), x_split=split)(params)
    only = tm.make_fused_value_and_grad((tX, tY), fwd_full=False, x_split=split)(params)
    np.testing.assert_array_equal(v1.numpy(), v0.numpy())
    for key in ("weights", "bias"):
        np.testing.assert_array_equal(g1[key].numpy(), g0[key].numpy())
        np.testing.assert_array_equal(only[key].numpy(), g0[key].numpy())
