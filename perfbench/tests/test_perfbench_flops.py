"""The work counts at the cells' shapes: chip_smoke.py phase 3's numbers."""

import pytest

from perfbench.yardstick import flops, peaks


def test_likelihood_gemms_at_bench_shape():
    # two GEMMs of 2 N (D+1) C K flop a call: 241.2 GFLOP at N 60,000, C K 1,280
    likelihood = 2 * 2 * 60000 * 785 * 1280
    assert likelihood == pytest.approx(241.152e9)
    assert likelihood / peaks.PEAK_BF16_FLOPS * 1e3 == pytest.approx(0.2438, abs=1e-4)


def test_vag_call_adds_the_whitening_maps():
    total = flops.softmax_vag_flop(60000, 784, 10, 128)
    # one GEMM by U_g and one by U_a each way: 244.35 GFLOP a call in all
    whitening = 2 * (2 * 785 ** 2 * 1280 + 2 * 785 * 10 * 1280)
    assert total == pytest.approx(241.152e9 + whitening)
    assert total == pytest.approx(244.347e9, rel=1e-5)
    bound = flops.softmax_vag_bound_s(60000, 784, 10, 128)
    assert bound == pytest.approx(total / peaks.PEAK_BF16_FLOPS)
    # bound by operations: the bytes need far less time
    assert flops.softmax_vag_bytes(60000, 784, 10, 128) / peaks.PEAK_BYTES_PER_S < bound / 5


def test_mlp_row_flop():
    # forward and backward GEMMs of 784-256-256-10: 3 x 2 x 268,800
    assert flops.mlp_row_flop((784, 256, 256, 10)) == 1612800
    step = flops.mlp_row_flop((784, 256, 256, 10)) * 1024 * 64
    assert step == pytest.approx(105.7e9, rel=1e-3)


def test_whitening_count_matches_the_ports_maps():
    # the GEMMs the port's whitened value+grad issues around its kernel:
    # unwhiten on the way in, unwhiten_transpose on the way out
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric

    d1, k, c = 13, 4, 3
    g = torch.Generator().manual_seed(0)
    s_g, U_g = np.linalg.eigh(np.cov(np.random.default_rng(0).normal(size=(d1, 40))))
    s_a, U_a = np.linalg.eigh(np.eye(k) / k - np.ones((k, k)) / k ** 2)
    metric = kron_metric.KronMetric((s_g, U_g), (np.maximum(s_a, 0), U_a), 1.0, "cpu")
    E = {"weights": torch.randn((c, d1 - 1, k), generator=g),
         "bias": torch.randn((c, k), generator=g)}
    with FlopCounterMode(display=False) as counter:
        metric.unwhiten_transpose(metric.unwhiten(E))
    n, dim = 50, d1 - 1
    likelihood = 2 * (2 * n * (dim + 1) * k * c)
    assert flops.softmax_vag_flop(n, dim, k, c) - likelihood == counter.get_total_flops()
