"""The port's CLI on the CPU: the config-3 pipeline on real pixels
(scikit-learn's digits) held to the assertions of the JAX package's
tests/test_nuts_batched.py::test_mnist_nuts_cli_digits_batched, configs 1 and
2 and the per-chain ``mnist-nuts`` modes at small size, every JSON line's keys
against the JAX CLI's line of the same subcommand (without ``compile_s``:
the port compiles nothing), and the options that are not ported yet.
Imports no jax."""

import contextlib
import io
import json
import math
import os
import tomllib

import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of the JAX CLI's batched ``mnist-nuts`` line (cli.py:400-404,
# :450-453, :461-470, :575-584; no compile_s on that path)
JAX_KEYS = {
    "min_ess", "median_ess", "max_rhat", "min_ess_per_sec", "median_ess_per_sec",
    "diag_s", "run_s", "sampler", "warmup_s", "chain_shards", "resumed",
    "draws_per_sec", "mean_tree_depth", "mean_leaves_per_draw", "mean_acceptance",
    "divergent_frac", "workload", "train_accuracy", "metric", "setup_s",
    "setup_from_cache", "dataset", "predictive_accuracy", "predictive_ece",
    "predictive_nll",
}


# the summarize() aggregate with elapsed seconds (JAX cli.py:141-143)
AGG_KEYS = {"min_ess", "median_ess", "max_rhat", "min_ess_per_sec", "median_ess_per_sec"}
# mvn-hmc (cli.py:170-175), logistic-hmc (:203-208), per-chain mnist-nuts
# (:547, :572-584)
MVN_KEYS = AGG_KEYS | {"workload", "run_s"}
LOGISTIC_KEYS = MVN_KEYS | {"test_accuracy"}
PER_CHAIN_KEYS = AGG_KEYS | {
    "run_s", "sampler", "workload", "train_accuracy", "metric", "setup_s", "setup_from_cache",
    "dataset", "predictive_accuracy", "predictive_ece", "predictive_nll",
}


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def one_thread():
    """Thousands of tiny ops: one intra-op thread is as fast alone and does
    not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mnist_nuts_cli_digits_on_cpu(one_thread):
    agg = _run(["mnist-nuts", "--dataset", "digits", "--chains", "4", "--samples", "30",
                "--warmup", "50", "--max-depth", "5", "--device", "cpu"])
    assert set(agg) == JAX_KEYS | {"device"}
    assert agg["device"] == "cpu"
    assert agg["sampler"] == "batched-nuts"
    assert agg["dataset"] == "sklearn-digits"
    assert agg["metric"] == "kron-gauss-newton"
    assert agg["train_accuracy"] > 0.9
    assert agg["predictive_accuracy"] > 0.9
    assert agg["mean_tree_depth"] >= 1.0
    assert agg["divergent_frac"] < 0.05
    assert agg["mean_leaves_per_draw"] <= 2 ** 5 - 1
    assert math.isfinite(agg["max_rhat"]) and 0 < agg["min_ess"] <= agg["median_ess"] <= 4 * 30


@pytest.mark.parametrize("extra", [[], ["--nuts"]], ids=["hmc", "nuts"])
def test_mvn_hmc_cli_on_cpu(one_thread, extra):
    agg = _run(["mvn-hmc", "--chains", "4", "--samples", "300", "--warmup", "200",
                "--device", "cpu"] + extra)
    assert set(agg) == MVN_KEYS | {"device"}
    assert agg["workload"] == "mvn-hmc" and agg["device"] == "cpu"
    assert agg["max_rhat"] < 1.05
    assert 300 < agg["min_ess"] <= agg["median_ess"]
    assert agg["min_ess_per_sec"] == pytest.approx(agg["min_ess"] / agg["run_s"], rel=0.05)


def test_logistic_hmc_cli_on_cpu(one_thread):
    agg = _run(["logistic-hmc", "--chains", "8", "--samples", "200", "--warmup", "150",
                "--device", "cpu"])
    assert set(agg) == LOGISTIC_KEYS | {"device"}
    assert agg["workload"] == "logistic-hmc"
    assert agg["test_accuracy"] >= 0.98
    assert agg["max_rhat"] < 1.05 and agg["min_ess"] > 0.25 * 8 * 200


@pytest.mark.parametrize("mode, metric", [("--per-chain-nuts", "kron-gauss-newton"),
                                          ("--diag-mass", "diag")],
                         ids=["per-chain-nuts", "diag-mass"])
def test_mnist_nuts_per_chain_modes_on_cpu(one_thread, mode, metric):
    """The two modes that run the per-chain kernel: with the Kronecker metric
    passed as ``metric=`` the chains start from the Laplace draw and stay at
    the mode's accuracy; with a diagonal mass they run (and need not mix)."""
    agg = _run(["mnist-nuts", "--dataset", "digits", "--chains", "4", "--samples", "30",
                "--warmup", "40", "--max-depth", "4", "--device", "cpu", mode])
    assert set(agg) == PER_CHAIN_KEYS | {"device"}
    assert agg["sampler"] == "per-chain-nuts" and agg["metric"] == metric
    assert agg["dataset"] == "sklearn-digits" and agg["setup_from_cache"] is False
    for key in ("min_ess", "median_ess", "max_rhat", "predictive_nll", "predictive_ece"):
        assert math.isfinite(agg[key]), key
    assert agg["train_accuracy"] > 0.9 and agg["predictive_accuracy"] > 0.9
    if mode == "--per-chain-nuts":
        assert agg["setup_s"] > 0 and agg["max_rhat"] < 1.5
    else:
        assert agg["setup_s"] == 0.0


@pytest.mark.parametrize("sub", ["mvn-hmc", "logistic-hmc"])
def test_small_configs_refuse_unported_options(sub):
    with pytest.raises(NotImplementedError, match=r"--save: .*not ported yet \(ROADMAP slice 5\)"):
        cli.main([sub, "--device", "cpu", "--save", "draws.h5"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([sub])


@pytest.mark.parametrize("extra, item", [
    (["--save", "draws.h5"], "slice 5"),
    (["--stream-chunk", "10"], "slice 5"),
    (["--checkpoint", "ck.npz"], "slice 5"),
    (["--resume"], "slice 5"),
    (["--chain-shards", "2"], "slice 5"),
    (["--data", "mnist.h5"], "slice 5"),
], ids=["save", "stream-chunk", "checkpoint", "resume", "chain-shards", "data"])
def test_cli_unported_options_raise(extra, item):
    with pytest.raises(NotImplementedError, match=f"not ported yet \\(ROADMAP {item}\\)"):
        cli.main(["mnist-nuts", "--device", "cpu"] + extra)


def test_cli_cuda_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["mnist-nuts", "--dataset", "digits"])


def test_console_script_and_package_discovery():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    assert scripts["dhmc-torch"] == "dropout_hamiltonian_montecarlo_tpu_torch.cli:main"
    # the discovery glob ships the port's package beside the JAX one
    (pattern,) = project["tool"]["setuptools"]["packages"]["find"]["include"]
    assert "dropout_hamiltonian_montecarlo_tpu_torch".startswith(pattern.rstrip("*"))
