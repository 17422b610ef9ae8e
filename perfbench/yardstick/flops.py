"""The work a cell's calls need, counted from the cell's shapes, whatever
implements them.

The softmax arithmetic is chip_smoke.py phase 3's (two GEMMs of
2 N (D+1) C K flop a value+grad call, X read once as bf16, W, b, Y and the
outputs once as float32), with the whitening maps added: on the way in
e -> q = U_g (e / sqrt d) U_a^T, on the way out g -> g_e = U_g^T g U_a / sqrt d,
each a GEMM of 2 (D+1)^2 C K flop by U_g and one of 2 (D+1) K^2 C by U_a."""

from __future__ import annotations

from .peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S


def softmax_vag_flop(n: int, dim: int, n_classes: int, chains: int) -> float:
    """Flop of one whitened value+grad or grad-only call for all chains."""
    ck = n_classes * chains
    likelihood = 2 * (2 * n * (dim + 1) * ck)
    whitening = 2 * (2 * (dim + 1) ** 2 * ck + 2 * (dim + 1) * n_classes * ck)
    return float(likelihood + whitening)


def softmax_vag_bytes(n: int, dim: int, n_classes: int, chains: int) -> float:
    """Bytes one call needs to move: each input read once, each output
    written once.  X in the bf16 the kernel is handed (exact on the 8-bit
    grid), Y, the whitening factors, the MAP, the positions and the
    gradients in float32, one value a chain."""
    ck = n_classes * chains
    x = 2 * n * dim
    y = 4 * n * n_classes
    factors = 4 * ((dim + 1) ** 2 + n_classes ** 2 + 2 * (dim + 1) * n_classes)
    params = 4 * 2 * (dim + 1) * ck
    return float(x + y + factors + params + 4 * chains)


def softmax_vag_bound_s(n: int, dim: int, n_classes: int, chains: int) -> float:
    """The least time one call can take: the larger of its flop at the
    dense bf16 peak and its bytes at the HBM bandwidth."""
    return max(softmax_vag_flop(n, dim, n_classes, chains) / PEAK_BF16_FLOPS,
               softmax_vag_bytes(n, dim, n_classes, chains) / PEAK_BYTES_PER_S)


def mlp_row_flop(layers) -> float:
    """Model flop of one row through an MLP of widths ``layers`` (e.g.
    (784, 256, 256, 10)) for one gradient: the forward GEMMs and the
    backward's two (3 x 2 x fan_in x fan_out per layer)."""
    return float(sum(3 * 2 * a * b for a, b in zip(layers[:-1], layers[1:])))
